"""The port's control plane starts without torch, as the reference's
starts without JAX: ``platform/main.py`` and every module its seven
services load import with ``torch`` and ``triton`` blocked (the
reference's with ``jax`` blocked), a plain import of the entrypoint
leaves the accelerator stack unloaded, and the controllers process
(activator on) serves ``/healthz`` with torch blocked."""
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every module ``python -m kubeflow_tpu_torch.platform.main <service>``
# loads for its seven services (``run_controllers``, ``run_webhook``,
# ``run_web_app``), the activator and the demo included.
PORT_MODULES = [
    "kubeflow_tpu_torch.platform.main",
    "kubeflow_tpu_torch.platform.demo",
    "kubeflow_tpu_torch.platform.native",
    "kubeflow_tpu_torch.platform.k8s.client",
    "kubeflow_tpu_torch.platform.k8s.types",
    # controllers
    "kubeflow_tpu_torch.platform.controllers.culling",
    "kubeflow_tpu_torch.platform.controllers.gpujob",
    "kubeflow_tpu_torch.platform.controllers.inferenceservice",
    "kubeflow_tpu_torch.platform.controllers.notebook",
    "kubeflow_tpu_torch.platform.controllers.profile",
    "kubeflow_tpu_torch.platform.controllers.tensorboard",
    "kubeflow_tpu_torch.platform.runtime",
    "kubeflow_tpu_torch.platform.runtime.flight",
    "kubeflow_tpu_torch.platform.runtime.informer",
    "kubeflow_tpu_torch.platform.runtime.jobqueue",
    "kubeflow_tpu_torch.platform.runtime.metrics",
    "kubeflow_tpu_torch.platform.runtime.sharding",
    "kubeflow_tpu_torch.platform.runtime.trace",
    "kubeflow_tpu_torch.platform.activator",
    "kubeflow_tpu_torch.telemetry.causal",
    "kubeflow_tpu_torch.telemetry.fleetscrape",
    "kubeflow_tpu_torch.telemetry.goodput",
    "kubeflow_tpu_torch.telemetry.incidents",
    "kubeflow_tpu_torch.telemetry.profiler",
    "kubeflow_tpu_torch.telemetry.serve",
    "kubeflow_tpu_torch.telemetry.slo",
    # webhook
    "kubeflow_tpu_torch.platform.webhook.server",
    # jupyter, volumes, tensorboards, kfam, dashboard
    "kubeflow_tpu_torch.platform.apps.jupyter.app",
    "kubeflow_tpu_torch.platform.apps.volumes.app",
    "kubeflow_tpu_torch.platform.apps.tensorboards.app",
    "kubeflow_tpu_torch.platform.kfam.app",
    "kubeflow_tpu_torch.platform.dashboard.app",
    "kubeflow_tpu_torch.platform.dashboard.metrics_service",
]
REF_MODULES = [m.replace("kubeflow_tpu_torch", "kubeflow_tpu")
               .replace("gpujob", "tpujob") for m in PORT_MODULES]
# package -> (the accelerator stack it must start without, its modules)
CASES = {
    "port": (("torch", "triton"), PORT_MODULES),
    "reference": (("jax", "jaxlib", "flax", "optax"), REF_MODULES),
}


def _python(code, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))


@pytest.mark.parametrize("package", sorted(CASES))
def test_service_modules_import_with_the_accelerator_stack_blocked(package):
    blocked, modules = CASES[package]
    out = _python(f"""
        import importlib, sys
        for name in {blocked!r}:
            sys.modules[name] = None
        for name in {modules!r}:
            importlib.import_module(name)
        print("imported", len({modules!r}))
    """)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["imported", str(len(modules))]


@pytest.mark.parametrize("package,stack", [
    ("kubeflow_tpu_torch", "torch"),
    ("kubeflow_tpu", "jax"),
])
def test_a_plain_import_of_the_entrypoint_loads_no_accelerator_stack(
        package, stack):
    out = _python(f"""
        import sys
        import {package}.platform.main
        print({stack!r} in sys.modules)
    """)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "False"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_200(url, proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"exited {proc.returncode}")
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                if r.status == 200:
                    return json.loads(r.read())
        except (urllib.error.URLError, ConnectionError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"{url} never answered 200")


def test_controllers_process_serves_healthz_with_torch_blocked(tmp_path):
    from kubeflow_tpu_torch.platform.testing.fake import FakeKube
    from kubeflow_tpu_torch.platform.testing.httpkube import HttpKubeServer

    kube = FakeKube()
    kube.add_namespace("kubeflow")
    server = HttpKubeServer(kube).start()
    kubeconfig = tmp_path / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "k",
                                               "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": server.base_url}}],
        "users": [{"name": "u", "user": {}}]}))
    health, act = _free_port(), _free_port()
    code = textwrap.dedent("""
        import runpy, sys
        for name in ("torch", "triton"):
            sys.modules[name] = None
        sys.argv = ["main"] + sys.argv[1:]
        runpy.run_module("kubeflow_tpu_torch.platform.main",
                         run_name="__main__", alter_sys=True)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, KUBECONFIG=str(kubeconfig),
               KFT_ACTIVATOR_PORT=str(act), POD_NAMESPACE="kubeflow")
    log = tmp_path / "controllers.log"
    with open(log, "w") as out_file:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, "controllers", "--health-port",
             str(health)], cwd=REPO, env=env, stdout=out_file,
            stderr=subprocess.STDOUT, text=True)
    try:
        body = _wait_200(f"http://127.0.0.1:{health}/healthz", proc)
        assert body["healthy"] is True
        _wait_200(f"http://127.0.0.1:{act}/healthz", proc)
        # SIGTERM once the process waits for it (its last start-up line).
        deadline = time.monotonic() + 30
        while "controllers running" not in log.read_text():
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        finally:
            server.stop()
    out = log.read_text()
    assert proc.returncode == 0, out
    assert "Traceback" not in out, out
