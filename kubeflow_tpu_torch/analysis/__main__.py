"""CLI: ``python -m kubeflow_tpu_torch.analysis [paths...]``.

Exit codes: 0 clean (after suppressions + baseline), 1 findings, 2 usage.
The port's gate (``tests/test_torch_analysis.py`` and the card check's
``platform_services`` phase) runs::

    python -m kubeflow_tpu_torch.analysis --baseline ci/kftlint_torch_baseline.json

``--write-baseline`` rewrites the baseline from the current findings —
the ratchet move when landing a new rule over existing debt.
"""
from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.analysis import engine
from kubeflow_tpu_torch.analysis import rules as _rules  # noqa: F401  (registers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.analysis",
        description="kftlint: repo-native invariant linting (docs/analysis.md)")
    ap.add_argument("paths", nargs="*",
                    help="repo-relative files to lint "
                         "(default: kubeflow_tpu_torch/)")
    ap.add_argument("--root", default=".",
                    help="repo root the paths/scopes resolve against")
    ap.add_argument("--baseline", default=None,
                    help="JSON baseline; matching findings don't fail the run")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite --baseline from the current findings")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in engine.all_rules():
            print(f"{rule.id}  {rule.summary}")
        return 0

    findings = engine.lint_paths(args.paths or None, root=args.root)

    if args.write_baseline:
        if not args.baseline:
            print("--write-baseline requires --baseline", file=sys.stderr)
            return 2
        engine.write_baseline(findings, args.baseline)
        print(f"baseline: wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = engine.load_baseline(args.baseline) if args.baseline else set()
    new = [f for f in findings
           if (f.rule, f.path, f.fingerprint) not in baseline]
    baselined = len(findings) - len(new)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.__dict__ for f in new],
            "baselined": baselined,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        print(f"kftlint: {len(new)} finding(s), {baselined} baselined")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
