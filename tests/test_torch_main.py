"""The port's production entrypoint (``kubeflow_tpu_torch/platform/
main.py``) and demo (``demo.py``) against the JAX package's.

* ``_serve_health``: both packages' health ports over the same manager
  state and the same registered sources (rule engine, goodput ledger,
  incident recorder, profiler, shard map, journeys), each route's status
  and JSON body compared.  Stripped: the engine string (each package's
  own library path) and the knob tables (each package's own registry,
  held apart); the index's words "GPUJob" and "GPU-second" are the
  reference's "TPUJob" and "chip-second".
* The command line: ``--help``, its subcommands and its flags.
* A subprocess: ``python -m kubeflow_tpu_torch.platform.main
  controllers`` against ``HttpKubeServer`` with ``jax``, the JAX
  package, ``werkzeug``, ``requests``, ``yaml`` and ``prometheus_client``
  blocked: ``/healthz`` answers 200, a Profile is reconciled into its
  namespace, every ``/debug/`` route of the reference's health port
  answers, and SIGTERM ends it with 0; the dashboard the same way, and a
  bad kubeconfig ends the process with an error.
* ``demo.main`` against the reference's demo output."""
import contextlib
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu.platform import main as ref_main
from kubeflow_tpu.telemetry import causal as ref_causal
from kubeflow_tpu.telemetry import goodput as ref_goodput
from kubeflow_tpu.telemetry import incidents as ref_incidents
from kubeflow_tpu.telemetry import profiler as ref_profiler
from kubeflow_tpu.telemetry import slo as ref_slo
from kubeflow_tpu.telemetry.tsdb import TSDB as RefTSDB
from kubeflow_tpu_torch.platform import main
from kubeflow_tpu_torch.telemetry import causal, goodput, incidents, profiler
from kubeflow_tpu_torch.telemetry import slo
from kubeflow_tpu_torch.telemetry.tsdb import TSDB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "kubeflow_tpu", "werkzeug", "requests", "yaml",
           "prometheus_client")
TTFT = "serve_time_to_first_token_seconds_bucket"


class _Mgr:
    def __init__(self, ok=True):
        self.ok = ok

    def healthy(self):
        return self.ok


class _Shards:
    identity = "ctrl-0"
    num_shards = 4

    def owned(self):
        return {2, 0}

    def shard_map(self):
        return {0: "ctrl-0", 1: "ctrl-1", 2: "ctrl-0", 3: None}


class _Client:
    def health(self):
        return {"circuit": "closed", "consecutive_failures": 0}


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            body = r.read().decode()
            ctype = r.headers.get("Content-Type", "")
            status = r.status
    except urllib.error.HTTPError as e:
        return e.code, None
    if ctype.startswith("application/json"):
        body = json.loads(body)
        if isinstance(body, dict):
            body.pop("engine", None)
            if "knobs" in body:
                body["knobs"] = sorted(body["knobs"])[:0]
    return status, body


def ref_index_words(x):
    text = json.dumps(x).replace("GPUJob", "TPUJob").replace(
        "GPU-second", "chip-second")
    return json.loads(text)


def register(mods, TSDBc):
    """The same sources registered in one package's single slots."""
    slo_mod, gp_mod, inc_mod, prof_mod, causal_mod = mods
    db = TSDBc()
    for at, good, total in ((5.0, 0, 0), (10.0, 0, 50)):
        db.append(TTFT, {"le": "1.0"}, good, ts=at)
        db.append(TTFT, {"le": "+Inf"}, total, ts=at)
    rule = slo_mod.BurnRateRule(name="main-ttft", metric=TTFT, threshold=1.0,
                                objective=0.9, fast_burn=2.0, slow_burn=1.0)
    rec = inc_mod.IncidentRecorder(db, now=lambda: 10.0)
    eng = slo_mod.RuleEngine(db, [rule], incidents=rec, now=lambda: 10.0)
    eng.evaluate()
    acct = gp_mod.GoodputAccountant(now=lambda: 0.0)
    acct.tick([], at=0.0)
    acct.tick([gp_mod.WorkloadUse("team", 2.0, productive=1.0)], at=4.0)
    prof = prof_mod.Profiler(now=lambda: 10.0)
    slo_mod.register_debug_alerts(eng)
    gp_mod.register_debug_goodput(acct)
    inc_mod.register_debug_incidents(rec)
    prof_mod.register_debug_profiler(prof)
    causal_mod.STORE.record("reconcile", trace_id="e" * 32,
                            segment="reconcile", start_ts=1.0, end_ts=2.0)


def unregister(mods):
    slo_mod, gp_mod, inc_mod, prof_mod, causal_mod = mods
    slo_mod.register_debug_alerts(None)
    gp_mod.register_debug_goodput(None)
    inc_mod.register_debug_incidents(None)
    prof_mod.register_debug_profiler(None)
    causal_mod.STORE.clear()


PORT_MODS = (slo, goodput, incidents, profiler, causal)
REF_MODS = (ref_slo, ref_goodput, ref_incidents, ref_profiler, ref_causal)
ROUTES = ["/healthz", "/debug", "/debug/", "/debug/knobs", "/debug/shards",
          "/debug/queue", "/debug/alerts", "/debug/goodput",
          "/debug/activator", "/debug/journey/" + "e" * 32,
          "/debug/journey/" + "f" * 32, "/debug/incidents",
          "/debug/incidents/main-ttft-10", "/debug/incidents/nope",
          "/debug/traces?n=0", "/debug/traces?n=x&controller=nobody",
          "/debug/profile?list=1", "/debug/profile?window=99",
          "/debug/profile?diff=a", "/nope", "/debug/nope"]


@pytest.mark.parametrize("debug_traces", [True, False])
@pytest.mark.parametrize("registered", [True, False])
def test_health_routes_equal_the_reference(debug_traces, registered):
    out = []
    for mod, mods, TSDBc in ((ref_main, REF_MODS, RefTSDB),
                             (main, PORT_MODS, TSDB)):
        if registered:
            register(mods, TSDBc)
        server = mod._serve_health(_Mgr(), 0, host="127.0.0.1",
                                   debug_traces=debug_traces,
                                   client=_Client(), shards=_Shards())
        base = f"http://127.0.0.1:{server.server_port}"
        try:
            rows = []
            for path in ROUTES:
                status, body = _get(base, path)
                if path.startswith("/debug/journey/") and body:
                    for span in body["spans"]:
                        span.pop("span_id")
                if path == "/debug/profile?list=1" and body:
                    body = sorted(body)
                rows.append((path, status, body))
            rows.append(("/metrics",) + (_get(base, "/metrics")[0],))
        finally:
            server.shutdown()
            unregister(mods)
        out.append(json.loads(json.dumps(rows)))
    ref, got = out
    got_goodput = [r for r in got if r[0] == "/debug/goodput"][0]
    got_goodput[2] = json.loads(json.dumps(got_goodput[2]).replace(
        "GpuSeconds", "ChipSeconds"))
    for row in got:
        if row[0] == "/debug/incidents/main-ttft-10" and row[2]:
            row[2]["goodput"] = json.loads(json.dumps(
                row[2]["goodput"]).replace("GpuSeconds", "ChipSeconds"))
    assert ref_index_words(got) == ref
    statuses = dict((r[0], r[1]) for r in got)
    assert statuses["/healthz"] == 200 and statuses["/nope"] == 404
    assert statuses["/debug/alerts"] == (200 if registered else 404)
    assert statuses["/debug/journey/" + "e" * 32] == (
        200 if debug_traces else 404)


def test_unhealthy_manager_is_503_and_index_lists_every_surface():
    server = main._serve_health(_Mgr(ok=False), 0, host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        status, _ = _get(base, "/healthz")
        _, index = _get(base, "/debug/")
    finally:
        server.shutdown()
    assert status == 503
    assert set(index["debug"]) == {
        "/debug/knobs", "/debug/queue", "/debug/shards", "/debug/traces",
        "/debug/journey/<trace_id>", "/debug/alerts", "/debug/goodput",
        "/debug/profile", "/debug/incidents", "/debug/activator"}


def _cli(mod, argv):
    """(exit code, stdout, stderr) of ``mod.main(argv)`` for an argv that
    argparse answers itself."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
    return e.value.code, out.getvalue(), err.getvalue()


def test_help_and_subcommands_equal_the_reference():
    got = _cli(main, ["--help"])
    ref = _cli(ref_main, ["--help"])
    assert got[0] == ref[0] == 0
    choices = re.compile(r"\{([a-z,]+)\}")
    assert choices.search(got[1]).group(1) == choices.search(ref[1]).group(1)
    assert set(main.SERVICES) == set(
        choices.search(got[1]).group(1).split(","))
    for flag in ("--port", "--health-port"):
        assert flag in got[1] and flag in ref[1]
    assert "python -m kubeflow_tpu_torch.platform.main controllers" in got[1]
    for argv in (["nope"], [], ["dashboard", "--port", "x"]):
        code, _, err = _cli(main, argv)
        assert (code, bool(err)) == (_cli(ref_main, argv)[0], True) == \
            (2, True)
    help_ = subprocess.run(
        [sys.executable, "-c", _blocked_main(["--help"])], cwd=REPO,
        capture_output=True, text=True, timeout=60)
    assert help_.returncode == 0 and "dashboard" in help_.stdout


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _blocked_main(argv):
    """A ``python -c`` program that blocks the JAX stack and the serving
    libraries, then runs the port's entrypoint as ``-m`` would."""
    return textwrap.dedent(f"""
        import runpy, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.argv = ["main"] + {argv!r}
        runpy.run_module("kubeflow_tpu_torch.platform.main",
                         run_name="__main__", alter_sys=True)
    """)


def _kubeconfig(tmp_path, server_url):
    path = tmp_path / "kubeconfig.json"
    path.write_text(json.dumps({
        "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "k",
                                               "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": server_url}}],
        "users": [{"name": "u", "user": {}}]}))
    return path


def _wait_get(base, path, proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[0])
        try:
            with urllib.request.urlopen(base + path, timeout=5) as r:
                return r.status, r.read().decode()
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.1)
    raise AssertionError(f"{path} never answered")


def test_controllers_process_serves_and_reconciles(tmp_path):
    from kubeflow_tpu_torch.platform.k8s.types import LEASE, NAMESPACE
    from kubeflow_tpu_torch.platform.testing.fake import FakeKube
    from kubeflow_tpu_torch.platform.testing.httpkube import HttpKubeServer

    kube = FakeKube()
    kube.add_namespace("kubeflow")
    server = HttpKubeServer(kube).start()
    health, act = _free_port(), _free_port()
    env = dict(os.environ, KUBECONFIG=str(_kubeconfig(tmp_path,
                                                      server.base_url)),
               LEADER_ELECT="true", POD_NAMESPACE="kubeflow",
               POD_NAME="ctrl-0", KFT_ACTIVATOR_PORT=str(act),
               KFT_PIPELINE_INTERVAL_SECONDS="0.5", K8S_CLIENT_QPS="0",
               KFT_SLO_QUEUE_WAIT_SECONDS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", _blocked_main(
            ["controllers", "--health-port", str(health)])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = f"http://127.0.0.1:{health}"
    try:
        status, body = _wait_get(base, "/healthz", proc)
        body = json.loads(body)
        assert status == 200 and body["healthy"] is True
        assert body["engine"] and body["rest_client"]["circuit"] == "closed"
        kube.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                     "metadata": {"name": "team"},
                     "spec": {"owner": {"kind": "User",
                                        "name": "a@example.com"}}})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if any(ns["metadata"]["name"] == "team"
                   for ns in kube.list(NAMESPACE)):
                break
            time.sleep(0.1)
        else:
            raise AssertionError("profile never reconciled")
        (lease,) = kube.list(LEASE, "kubeflow")
        assert lease["spec"]["holderIdentity"].startswith(
            lease["metadata"]["name"])
        _wait_get(f"http://127.0.0.1:{act}", "/healthz", proc)
        time.sleep(1.2)   # two pipeline passes
        answers = {}
        for path in ("/debug/", "/debug/knobs", "/debug/queue",
                     "/debug/alerts", "/debug/goodput", "/debug/activator",
                     "/debug/journey/" + "0" * 32, "/debug/profile",
                     "/debug/incidents", "/debug/traces?n=2", "/metrics"):
            answers[path] = _get(base, path)
        assert all(status == 200 for status, _ in answers.values()), \
            {p: s for p, (s, _) in answers.items()}
        knobs = _get(base, "/debug/knobs")[1]
        # ("knobs" is emptied by _get; read it raw.)
        with urllib.request.urlopen(base + "/debug/knobs") as r:
            knobs = json.loads(r.read())["knobs"]
        assert knobs["KFT_SLO_QUEUE_WAIT_SECONDS"] == {
            "value": 1.0, "default": 300.0, "source": "env",
            "doc": "queue-wait latency threshold (s)"}
        assert knobs["LEADER_ELECT"]["source"] == "env"
        assert knobs["KFT_PROFILE_ENABLED"]["value"] is True
        page = answers["/metrics"][1]
        assert "kft_profile_samples_total" in page
        assert 'kft_alerts_firing{alert="queue-wait"} 0' in page
        assert "fleetscrape_samples_total" in page
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=30)
        finally:
            server.stop()
    assert proc.returncode == 0, out
    assert "controllers running" in out
    assert "Traceback" not in out and "failed" not in out, out


def test_dashboard_process_serves_and_bad_kubeconfig_fails(tmp_path):
    from kubeflow_tpu_torch.platform.testing.fake import FakeKube
    from kubeflow_tpu_torch.platform.testing.httpkube import HttpKubeServer

    kube = FakeKube()
    kube.add_namespace("kubeflow")
    kube.add_gpu_node("n", gpus=8)
    server = HttpKubeServer(kube).start()
    port = _free_port()
    env = dict(os.environ, KUBECONFIG=str(_kubeconfig(tmp_path,
                                                      server.base_url)),
               K8S_CLIENT_QPS="0")
    proc = subprocess.Popen(
        [sys.executable, "-c", _blocked_main(["dashboard", "--port",
                                              str(port)])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        status, page = _wait_get(base, "/", proc)
        assert status == 200 and "GPUs (cluster)" in page
        req = urllib.request.Request(
            base + "/api/gpu-overview",
            headers={"kubeflow-userid": "a@example.com"})
        with urllib.request.urlopen(req, timeout=10) as r:
            body = json.loads(r.read())
        assert body["clusterCapacityGPUs"] == 8
        req = urllib.request.Request(
            base + "/api/metrics/gpu",
            headers={"kubeflow-userid": "a@example.com"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 405
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=30)
        finally:
            server.stop()
    assert proc.returncode == 0, out
    bad = tmp_path / "bad.json"
    bad.write_text("apiVersion: v1\n")
    out = subprocess.run(
        [sys.executable, "-c", _blocked_main(["controllers",
                                              "--health-port", "0"])],
        cwd=REPO, env=dict(os.environ, KUBECONFIG=str(bad)),
        capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "is not JSON" in out.stderr


def test_missing_kubeconfig_never_falls_back(tmp_path, monkeypatch):
    """Without a cluster or a kubeconfig the entrypoint raises before
    it serves anything; it never carries on with an in-memory store."""
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "absent.json"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    for service in ("controllers", "dashboard", "webhook"):
        with pytest.raises(RuntimeError, match="absent.json"):
            main.main([service, "--port", "0", "--health-port", "0"])


def _demo_output(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().splitlines()


def test_demo_equals_the_reference():
    from kubeflow_tpu.platform import demo as ref_demo
    from kubeflow_tpu_torch.platform import demo

    rc, got = _demo_output(demo, ["--namespace", "demo-a"])
    ref_rc, ref = _demo_output(ref_demo, ["--namespace", "demo-a"])
    assert rc == ref_rc == 0 and got == ref
    rc, got = _demo_output(demo, ["--namespace", "demo-b", "--gpu",
                                  "h100-80gb", "--gpus", "8"])
    ref_rc, ref = _demo_output(ref_demo, ["--namespace", "demo-b", "--tpu",
                                          "v5e", "--topology", "2x4"])
    assert rc == ref_rc == 0
    assert got[0] == ("--> apply Notebook demo-b/my-notebook "
                      "(gpu=h100-80gb gpus=8)")
    assert ref[0].endswith("(tpu=v5e topology=2x4)")
    assert got[3] == '    gpu limits: {"nvidia.com/gpu": "8"}'
    assert ref[3] == '    chip limits: {"google.com/tpu": "8"}'
    assert '"nvidia.com/gpu.product"' in got[2]
    # The device lines differ by design; the flow's lines are the same.
    same = [0 if i in (0, 2, 3, 4) else i for i in range(len(ref))]
    assert [got[i] for i in same if i] == [ref[i] for i in same if i]
    assert len(got) == len(ref)
