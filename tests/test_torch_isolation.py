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
           "prometheus_client", "yaml", "requests", "cryptography")
# Absent from the card's machine, and imported only inside the function
# that needs it (the self-signed key generation), as the reference does.
LAZY = ("cryptography",)
# The one place the port names the JAX package as a module: a string in
# kftlint's R003 deny-list, which it matches import statements against
# (never an import itself). file -> its count of that string constant.
NAMES_THE_REFERENCE = {PKG / "analysis" / "rules.py": 1}


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
    assert int(out.stdout.strip()) >= 129


@pytest.mark.parametrize("module", [
    "kubeflow_tpu_torch.train.checkpoint",
    "kubeflow_tpu_torch.models.scheduler",
    "kubeflow_tpu_torch.models.paged",
    "kubeflow_tpu_torch.telemetry.compute",
    "kubeflow_tpu_torch.telemetry.profiler",
    "kubeflow_tpu_torch.telemetry.causal",
    "kubeflow_tpu_torch.parallel",
    "kubeflow_tpu_torch.parallel.envspec",
    "kubeflow_tpu_torch.parallel.dist",
    "kubeflow_tpu_torch.parallel.mesh",
    "kubeflow_tpu_torch.parallel.context",
    "kubeflow_tpu_torch.parallel.sharding",
    "kubeflow_tpu_torch.parallel.train",
    "kubeflow_tpu_torch.parallel.ring",
    "kubeflow_tpu_torch.parallel.ulysses",
    "kubeflow_tpu_torch.parallel.pipeline",
    "kubeflow_tpu_torch.parallel.lockstep",
    "kubeflow_tpu_torch.parallel.launch",
    "kubeflow_tpu_torch.platform.gpu.topology",
    "kubeflow_tpu_torch.platform.gpu.pods",
    "kubeflow_tpu_torch.platform.k8s.quota",
    "kubeflow_tpu_torch.platform",
    "kubeflow_tpu_torch.platform.k8s.types",
    "kubeflow_tpu_torch.platform.k8s.errors",
    "kubeflow_tpu_torch.platform.config",
    "kubeflow_tpu_torch.platform.runtime",
    "kubeflow_tpu_torch.platform.runtime.metrics",
    "kubeflow_tpu_torch.platform.runtime.events",
    "kubeflow_tpu_torch.platform.runtime.flight",
    "kubeflow_tpu_torch.platform.runtime.apply",
    "kubeflow_tpu_torch.platform.runtime.controller",
    "kubeflow_tpu_torch.platform.testing.fake",
    "kubeflow_tpu_torch.platform.apis.notebook",
    "kubeflow_tpu_torch.platform.apis.poddefault",
    "kubeflow_tpu_torch.platform.controllers.notebook",
    "kubeflow_tpu_torch.platform.apis.gpujob",
    "kubeflow_tpu_torch.platform.apis.inferenceservice",
    "kubeflow_tpu_torch.platform.runtime.jobqueue",
    "kubeflow_tpu_torch.platform.controllers.gpujob",
    "kubeflow_tpu_torch.platform.testing.jobsim",
    "kubeflow_tpu_torch.platform.webhook.jsonpatch",
    "kubeflow_tpu_torch.platform.webhook.mutate",
    "kubeflow_tpu_torch.platform.k8s.client",
    "kubeflow_tpu_torch.platform.runtime.trace",
    "kubeflow_tpu_torch.platform.runtime.informer",
    "kubeflow_tpu_torch.platform.runtime.leader",
    "kubeflow_tpu_torch.platform.controllers.culling",
    "kubeflow_tpu_torch.platform.runtime.sharding",
    "kubeflow_tpu_torch.platform.testing.chaos",
    "kubeflow_tpu_torch.platform.testing.shardfleet",
    "kubeflow_tpu_torch.platform.k8s.codec",
    "kubeflow_tpu_torch.platform.native",
    "kubeflow_tpu_torch.platform.testing.httpkube",
    "kubeflow_tpu_torch.data.packing",
    "kubeflow_tpu_torch.platform.webhook.certs",
    "kubeflow_tpu_torch.platform.webhook.server",
    "kubeflow_tpu_torch.telemetry.metrics",
    "kubeflow_tpu_torch.telemetry.tsdb",
    "kubeflow_tpu_torch.telemetry.fleetscrape",
    "kubeflow_tpu_torch.platform.runtime.autoscale",
    "kubeflow_tpu_torch.platform.activator",
    "kubeflow_tpu_torch.platform.controllers.inferenceservice",
    "kubeflow_tpu_torch.platform.testing.servesim",
    "kubeflow_tpu_torch.platform.web",
    "kubeflow_tpu_torch.platform.web.framework",
    "kubeflow_tpu_torch.platform.web.crud_backend",
    "kubeflow_tpu_torch.platform.web.static_serving",
    "kubeflow_tpu_torch.platform.controllers.profile",
    "kubeflow_tpu_torch.platform.controllers.tensorboard",
    "kubeflow_tpu_torch.platform.kfam.bindings",
    "kubeflow_tpu_torch.platform.kfam.app",
    "kubeflow_tpu_torch.platform.apps.jupyter.form",
    "kubeflow_tpu_torch.platform.apps.jupyter.status",
    "kubeflow_tpu_torch.platform.apps.jupyter.app",
    "kubeflow_tpu_torch.platform.apps.volumes.app",
    "kubeflow_tpu_torch.platform.apps.tensorboards.app",
    "kubeflow_tpu_torch.telemetry.critical_path",
    "kubeflow_tpu_torch.telemetry.slo",
    "kubeflow_tpu_torch.telemetry.goodput",
    "kubeflow_tpu_torch.telemetry.incidents",
    "kubeflow_tpu_torch.platform.dashboard",
    "kubeflow_tpu_torch.platform.dashboard.metrics_service",
    "kubeflow_tpu_torch.platform.dashboard.app",
    "kubeflow_tpu_torch.platform.main",
    "kubeflow_tpu_torch.platform.demo",
])
def test_checkpoint_and_scheduler_stand_alone(module):
    """The modules that save and serve a trained model, the replica's
    telemetry, the parallel package, the platform's GPU seams and its
    control plane (API types, the in-memory API server, the reconcilers
    and the culler, the webhook, the controller runtime with its
    informers, leader election and shard leases, the chaos wrapper and
    the sharded fleet, the REST client, the wire codec, the native
    engine's loader and the HTTP server, the packer on the engine, and
    the serving front door: the webhook's TLS server and its pair, the
    text parser, the TSDB, the fleet scrape, the autoscaler, the
    activator, the InferenceService controller and the fleet sim; and
    the user's front door: the web framework, the CRUD backend, static
    serving, the profile and tensorboard controllers, KFAM and the
    Jupyter, volumes and tensorboards apps; and the fleet telemetry (the
    critical path, the SLO rules, goodput, the incident recorder), the
    dashboard, the entrypoint and the demo) import with JAX, the JAX package, the serving libraries, yaml,
    requests and cryptography blocked, and pull none of them in."""
    path = REPO / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = REPO / module.replace(".", "/") / "__init__.py"
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
    in_functions = {id(n) for f in ast.walk(tree)
                    if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            if top in LAZY and id(node) in in_functions:
                continue
            assert top not in BLOCKED, f"{path}:{node.lineno} imports {mod}"
    text = path.read_text()
    assert "import jax" not in text
    named = sum(isinstance(n, ast.Constant) and n.value == "kubeflow_tpu"
                for n in ast.walk(tree))
    assert named == NAMES_THE_REFERENCE.get(path, 0)
    text = text.replace('"kubeflow_tpu"', '""', named)
    # The JAX package may be named as a file path in documentation
    # ("kubeflow_tpu/ops/..."), never as a module.
    assert re.search(r"kubeflow_tpu(?!_torch)(?!/)", text) is None


# Source files only: a compiled .pyc appears once a module is imported.
FRONT_DOOR = sorted(
    p for d in ("frontend", "apps")
    for p in (PKG / "platform" / d).rglob("*")
    if p.suffix in (".py", ".js", ".html", ".css", ".json", ".yaml"))


def test_the_front_door_is_not_the_reference_files():
    """The SPAs and the apps were copied and rewritten, not linked."""
    assert {p.suffix for p in FRONT_DOOR} >= {".py", ".js", ".html",
                                              ".css", ".json"}
    assert not any(p.is_symlink() for p in FRONT_DOOR)


@pytest.mark.parametrize("path", FRONT_DOOR,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_front_door_files_name_no_yaml_werkzeug_or_tpu_resource(path):
    """No file of the port's SPAs or apps names ``yaml`` (the spawner's
    config is JSON; the card's machine has no YAML parser), ``werkzeug``
    (the apps run on the port's framework) or ``google.com/tpu`` (the
    resource is ``nvidia.com/gpu``).  The check is on the lower-case
    word: the detail page's tab that renders an object in YAML syntax is
    named "manifest" in the code and "YAML" on screen."""
    text = path.read_text()
    for word in ("yaml", "werkzeug", "google.com/tpu"):
        assert word not in text, f"{path.relative_to(REPO)} names {word}"
    assert path.suffix != ".yaml"


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


def test_native_engine_never_opens_the_reference_library():
    """The port's engine builds from its own sources and loads its own
    library: no file it opens, no library it loads and no command it runs
    names a path under the JAX package's ``kubeflow_tpu/``."""
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        seen = []

        def audit(event, args):
            if event in ("open", "ctypes.dlopen", "subprocess.Popen",
                         "os.listdir", "os.scandir"):
                seen.append((event, repr(args)))

        sys.addaudithook(audit)
        from kubeflow_tpu_torch.platform import native
        from kubeflow_tpu_torch.platform.k8s import codec
        native.build(force=True)
        assert native.available(), native.load_error()
        codec.decode_event(b'{{"type":"ADDED","object":{{}}}}')
        dlopens = [a for e, a in seen if e == "ctypes.dlopen"
                   and str({str(REPO)!r}) in a]
        assert dlopens == [repr((str(native.LIB_PATH),))], dlopens
        assert not any("libkfnative" in a for e, a in seen)
        bad = [s for s in seen if {str(REPO / "kubeflow_tpu")!r} + "/"
               in s[1] or "kubeflow_tpu/_native" in s[1]]
        assert not bad, bad
        print(len(seen))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 0
