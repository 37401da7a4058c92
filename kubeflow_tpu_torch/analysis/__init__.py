"""kftlint for the port: repo-native invariant linting of
``kubeflow_tpu_torch/``.  The port's copy of ``kubeflow_tpu/analysis/``;
it imports the standard library only (``ast``, ``fnmatch``, ``hashlib``,
``json``), neither torch nor anything of the JAX package.

The control plane's hardest bugs (fence overlap, a stale-generation pod
kill, a status-merge wipe) were violations of *repo-specific* contracts
(fenced writes, frozen-view reads, status via patch, a control plane
free of the accelerator stack) that generic linters cannot know about.
This package checks them statically:

* ``engine``: the AST lint driver: rule registry, per-line and per-file
  ``# kft: disable=RULE <reason>`` suppressions, a checked-in baseline
  so a new rule can land green and ratchet down.
* ``rules``: the rule set (R001..R010); ``docs/analysis.md`` is the
  rule reference.

Run it over the port's tree from the repo root::

    python -m kubeflow_tpu_torch.analysis --baseline ci/kftlint_torch_baseline.json

Exit is nonzero on any unsuppressed, un-baselined finding.
"""
from kubeflow_tpu_torch.analysis.engine import (  # noqa: F401
    Finding,
    Rule,
    all_rules,
    lint_paths,
    lint_source,
    load_baseline,
    write_baseline,
)
from kubeflow_tpu_torch.analysis import rules as _rules  # noqa: F401  (registers)
