"""The port's kftlint (``kubeflow_tpu_torch/analysis/``) held against the
reference's (``kubeflow_tpu/analysis/``): the same ten rules, the same
findings on the reference's corpus twins (read in place, the package
names and pretend paths rewritten to the port's), R003's port-only
roots, the same suppressions, baseline and fingerprints, the CLI's exit
codes, and the port's own tree clean under its empty baseline."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from kubeflow_tpu.analysis import engine as ref_engine
from kubeflow_tpu.analysis import rules as _ref_rules  # noqa: F401
from kubeflow_tpu_torch.analysis import engine
from kubeflow_tpu_torch.analysis import rules as _rules  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(REPO, "tests", "ctrlplane", "lintcorpus")
BASELINE = os.path.join(REPO, "ci", "kftlint_torch_baseline.json")

# rule id -> the reference's pretend paths (tests/ctrlplane/test_analysis.py)
# for its bad twin and, where the rule keys off the module, its good twin.
CORPUS = {
    "R001": ("kubeflow_tpu/platform/controllers/corpus.py", None),
    "R002": ("kubeflow_tpu/platform/controllers/corpus.py", None),
    "R003": ("kubeflow_tpu/platform/controllers/corpus.py", None),
    "R004": ("kubeflow_tpu/platform/controllers/corpus.py", None),
    "R005": ("kubeflow_tpu/models/corpus.py", None),
    "R006": ("kubeflow_tpu/platform/runtime/corpus.py", None),
    "R007": ("kubeflow_tpu/platform/controllers/corpus.py",
             "kubeflow_tpu/platform/runtime/metrics.py"),
    "R008": ("kubeflow_tpu/platform/controllers/corpus.py", None),
    "R009": ("kubeflow_tpu/platform/controllers/corpus.py", None),
    "R010": ("kubeflow_tpu/platform/runtime/corpus.py", None),
}
R003_SUMMARY = ("platform/controllers and platform/runtime must be "
                "import-time torch- and jax-free")


def to_port(text: str) -> str:
    """The reference's package name, in code, paths and messages, as the
    port's."""
    return text.replace("kubeflow_tpu", "kubeflow_tpu_torch")


def _corpus(rule_id: str, kind: str) -> str:
    with open(os.path.join(CORPUS_DIR, f"{rule_id.lower()}_{kind}.py")) as f:
        return f.read()


def _triples(findings):
    return [(f.rule, f.line, f.message) for f in findings]


def test_registry_has_the_references_ten_rules():
    port = {r.id: r.summary for r in engine.all_rules()}
    ref = {r.id: r.summary for r in ref_engine.all_rules()}
    assert sorted(port) == [f"R00{i}" for i in range(1, 10)] + ["R010"]
    assert sorted(port) == sorted(ref) == sorted(CORPUS)
    assert port.pop("R003") == R003_SUMMARY
    ref.pop("R003")
    assert port == ref


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule_id", sorted(CORPUS))
def test_corpus_twin_gives_the_references_findings(rule_id, kind):
    bad_path, good_path = CORPUS[rule_id]
    path = (good_path or bad_path) if kind == "good" else bad_path
    text = _corpus(rule_id, kind)
    want = [(r, n, to_port(m)) for r, n, m in
            _triples(ref_engine.lint_source(text, path))]
    got = _triples(engine.lint_source(to_port(text), to_port(path)))
    assert got == want
    if kind == "bad":
        assert got and {r for r, _, _ in got} == {rule_id}
    else:
        assert got == []


R003_PORT_ROOTS = ["import torch", "import triton",
                   "from kubeflow_tpu_torch import models",
                   "import kubeflow_tpu"]
CONTROLLER = "kubeflow_tpu_torch/platform/controllers/corpus.py"


@pytest.mark.parametrize("stmt", R003_PORT_ROOTS)
def test_r003_fires_on_a_module_level_port_accelerator_import(stmt):
    findings = engine.lint_source(f"{stmt}\n", CONTROLLER)
    assert [(f.rule, f.line) for f in findings] == [("R003", 1)]
    assert "drags the accelerator stack" in findings[0].message


@pytest.mark.parametrize("stmt", R003_PORT_ROOTS)
def test_r003_is_silent_on_the_same_import_inside_a_function(stmt):
    src = f"def reconcile(req):\n    {stmt}\n    return req\n"
    assert engine.lint_source(src, CONTROLLER) == []
    runtime = "kubeflow_tpu_torch/platform/runtime/corpus.py"
    assert engine.lint_source(src, runtime) == []


# -- suppressions, through both engines on the same text ----------------------

_BAD_ENV = "import os\nTIMEOUT = os.environ.get('X', '1')\n"
SUPPRESSION_CASES = {
    "none": (_BAD_ENV, "kubeflow_tpu/models/x.py"),
    "same_line": (_BAD_ENV.replace(
        "'1')\n", "'1')  # kft: disable=R005 migration pending\n"),
        "kubeflow_tpu/models/x.py"),
    "line_above": ("import os\n"
                   "# kft: disable=R005 migration pending\n"
                   "TIMEOUT = os.environ.get('X', '1')\n",
                   "kubeflow_tpu/models/x.py"),
    "file": ("# kft: disable-file=R005 generated shim\n" + _BAD_ENV,
             "kubeflow_tpu/models/x.py"),
    "one_rule_keeps_others": ("import os\n"
                              "def f():\n"
                              "    try:\n"
                              "        return os.environ['X']  "
                              "# kft: disable=R005 demo\n"
                              "    except Exception:\n"
                              "        pass\n",
                              "kubeflow_tpu/platform/runtime/x.py"),
}
SUPPRESSED_RULES = {"none": {"R005"}, "same_line": set(), "line_above": set(),
                    "file": set(), "one_rule_keeps_others": {"R006"}}


@pytest.mark.parametrize("case", sorted(SUPPRESSION_CASES))
def test_suppressions_equal_the_references(case):
    text, path = SUPPRESSION_CASES[case]
    want = [(r, n, to_port(m)) for r, n, m in
            _triples(ref_engine.lint_source(text, path))]
    got = engine.lint_source(text, to_port(path))
    assert _triples(got) == want
    assert {f.rule for f in got} == SUPPRESSED_RULES[case]


def test_fingerprint_is_bit_equal_to_the_references():
    text, path = SUPPRESSION_CASES["none"]
    (f,) = engine.lint_source(text, to_port(path))
    norm = text.splitlines()[f.line - 1].strip()
    assert f.fingerprint == ref_engine._fingerprint(
        f.rule, f.path, norm, 0)
    for args in (("R001", "a.py", "x = 1", 0), ("R010", "b/c.py", "", 3)):
        assert engine._fingerprint(*args) == ref_engine._fingerprint(*args)


# -- baseline round trip and fingerprints over a tree -------------------------


def _trees(tmp_path):
    """One copy of r001_bad.py in a controller of each package's tree:
    {package: (lint engine, root, the file)}."""
    out = {}
    for name, eng in (("kubeflow_tpu", ref_engine),
                      ("kubeflow_tpu_torch", engine)):
        root = tmp_path / name
        ctrl = root / name / "platform" / "controllers"
        ctrl.mkdir(parents=True)
        shutil.copy(os.path.join(CORPUS_DIR, "r001_bad.py"), ctrl / "bad.py")
        out[name] = (eng, root, ctrl / "bad.py")
    return out


def _new(eng, root, baseline):
    return [f for f in eng.lint_paths(root=str(root))
            if (f.rule, f.path, f.fingerprint) not in baseline]


def test_baseline_round_trip_equals_the_references(tmp_path):
    seen = {}
    for name, (eng, root, _) in _trees(tmp_path).items():
        findings = eng.lint_paths(root=str(root))
        assert findings and all(f.rule == "R001" for f in findings)
        path = tmp_path / f"{name}.json"
        eng.write_baseline(findings, str(path))
        assert _new(eng, root, eng.load_baseline(str(path))) == []
        seen[name] = ([(r, n, to_port(m)) for r, n, m in _triples(findings)],
                      json.loads(path.read_text())["version"])
    assert seen["kubeflow_tpu_torch"] == seen["kubeflow_tpu"]


def test_baselined_finding_survives_unrelated_edits_as_in_the_reference(
        tmp_path):
    seen = {}
    for name, (eng, root, bad) in _trees(tmp_path).items():
        path = tmp_path / f"{name}.json"
        eng.write_baseline(eng.lint_paths(root=str(root)), str(path))
        baseline = eng.load_baseline(str(path))
        bad.write_text("# a new leading comment\n\n" + bad.read_text())
        shifted = _new(eng, root, baseline)
        bad.write_text(bad.read_text().replace(
            "self.client.inner.update(obj)",
            "self.client.inner.update(obj)  # tweaked"))
        touched = _new(eng, root, baseline)
        assert shifted == [] and len(touched) == 1
        seen[name] = [(r, n, to_port(m)) for r, n, m in _triples(touched)]
    assert seen["kubeflow_tpu_torch"] == seen["kubeflow_tpu"]


# -- the CLI ------------------------------------------------------------------


def _cli(*args):
    """``python -m kubeflow_tpu_torch.analysis *args`` with torch and
    triton blocked: the lint needs neither."""
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ("torch", "triton"):
            sys.modules[name] = None
        sys.argv = ["kftlint"] + {list(args)!r}
        runpy.run_module("kubeflow_tpu_torch.analysis", run_name="__main__",
                         alter_sys=True)
    """)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))


def test_cli_list_rules_equals_the_references_but_r003():
    out = _cli("--list-rules")
    ref = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu.analysis", "--list-rules"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == ref.returncode == 0, out.stderr
    port, want = out.stdout.splitlines(), ref.stdout.splitlines()
    assert port[2] == f"R003  {R003_SUMMARY}"
    assert port[:2] + port[3:] == want[:2] + want[3:]
    assert len(port) == 10


def test_cli_exit_codes(tmp_path):
    root = _trees(tmp_path)["kubeflow_tpu_torch"][1]
    dirty = _cli("--root", str(root), "--format", "json")
    assert dirty.returncode == 1, dirty.stderr
    payload = json.loads(dirty.stdout)
    assert payload["findings"] and payload["baselined"] == 0
    baseline = tmp_path / "b.json"
    assert _cli("--root", str(root), "--write-baseline").returncode == 2
    wrote = _cli("--root", str(root), "--baseline", str(baseline),
                 "--write-baseline")
    assert wrote.returncode == 0, wrote.stderr
    clean = _cli("--root", str(root), "--baseline", str(baseline))
    assert clean.returncode == 0, clean.stdout
    assert clean.stdout.strip() == (
        f"kftlint: 0 finding(s), {len(payload['findings'])} baselined")
    assert _cli("--format", "xml").returncode == 2


# -- the port's own tree ------------------------------------------------------


def test_port_tree_is_clean_under_its_empty_baseline():
    with open(BASELINE) as f:
        data = json.load(f)
    assert data == {"findings": [], "version": 1}
    findings = engine.lint_paths(root=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)
    out = _cli("--baseline", "ci/kftlint_torch_baseline.json")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "kftlint: 0 finding(s), 0 baselined"
