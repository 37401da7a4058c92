"""The PyTorch port stands alone: it imports without JAX, without the JAX
package and without the serving libraries the JAX package uses, and its
kernel build targets Hopper (sm_90a) into a directory git ignores."""
import ast
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "kubeflow_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "kubeflow_tpu", "werkzeug",
           "prometheus_client")


def test_every_module_imports_with_jax_and_reference_blocked():
    code = textwrap.dedent(f"""
        import pkgutil, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import kubeflow_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            kubeflow_tpu_torch.__path__, "kubeflow_tpu_torch.")]
        for name in names:
            __import__(name)
        import chip_smoke
        assert callable(chip_smoke.main)
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("module", [
    "kubeflow_tpu_torch.train.checkpoint",
    "kubeflow_tpu_torch.models.scheduler",
])
def test_checkpoint_and_scheduler_stand_alone(module):
    """The modules that save and serve a trained model import with JAX,
    the JAX package and the serving libraries blocked, and pull none of
    them in."""
    path = REPO / (module.replace(".", "/") + ".py")
    assert path in PORT_FILES
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import {module}
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in {BLOCKED!r}]
        assert not loaded, loaded
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in BLOCKED, f"{path}:{node.lineno} imports {mod}"
    text = path.read_text()
    assert "import jax" not in text
    # The JAX package may be named as a file path in documentation
    # ("kubeflow_tpu/ops/..."), never as a module.
    assert re.search(r"kubeflow_tpu(?!_torch)(?!/)", text) is None


def test_nvcc_command_targets_sm90a(tmp_path, monkeypatch):
    from kubeflow_tpu_torch.ops import _build

    calls = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)

        def communicate(self):
            return "", None

    def fake_run(cmd, **kw):
        calls.append(cmd)
        (tmp_path / _build.LIB_NAME).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, stdout="")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    lib = _build.build(tmp_path)
    assert lib == tmp_path / _build.LIB_NAME
    sources = {p.name for p in _build.sources()}
    assert {"rms_norm.cu", "flash_attention_fwd.cu",
            "flash_decode.cu"} <= sources
    compiles, link = calls[:-1], calls[-1]
    assert len(compiles) == len(sources)
    for cmd in calls:
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for cmd in compiles:
        assert {"-std=c++17", "-O3", "-c", "-fPIC"} <= set(cmd)
    assert "-shared" in link and str(lib) in link
    # Same sources, same flags: the second call builds nothing.
    calls.clear()
    assert _build.build(tmp_path) == lib and calls == []


def test_build_dir_is_ignored_by_git():
    from kubeflow_tpu_torch.ops import _build

    rel = _build.BUILD_DIR.relative_to(REPO).as_posix()
    assert rel == "build/kernels"
    ignored = (REPO / ".gitignore").read_text().split()
    assert rel + "/" in ignored or rel in ignored
