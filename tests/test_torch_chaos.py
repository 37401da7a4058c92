"""The port's ``ChaosKube`` (``kubeflow_tpu_torch/platform/testing/
chaos.py``) against the reference's: the four unit cases of
``tests/ctrlplane/test_chaos.py`` on both packages, each on its own
``FakeKube`` with the same seed and call sequence — the same fault
schedule, selector answers, injection bounds and pause — and a small
seeded storm over the port's notebook and culling controllers that
converges with every invariant intact and no dead letter.  Every wait
is bounded at 30 s."""
import threading
import time

import pytest

from kubeflow_tpu.platform.k8s import errors as ref_errors
from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.testing import ChaosKube as RefChaos
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu.platform.testing import Fault as RefFault
from kubeflow_tpu.platform.testing.chaos import storm as ref_storm
from kubeflow_tpu_torch.platform.controllers import culling
from kubeflow_tpu_torch.platform.controllers.notebook import make_controller
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s import types as port_types
from kubeflow_tpu_torch.platform.k8s.types import (
    NOTEBOOK,
    SERVICE,
    STATEFULSET,
    deep_get,
)
from kubeflow_tpu_torch.platform.runtime.controller import make_workqueue
from kubeflow_tpu_torch.platform.testing import ChaosKube, FakeKube, Fault
from kubeflow_tpu_torch.platform.testing.chaos import storm

SEED = 20260804
WAIT_S = 30.0


class Pkg:
    def __init__(self, port):
        self.Kube = FakeKube if port else RefKube
        self.Chaos = ChaosKube if port else RefChaos
        self.Fault = Fault if port else RefFault
        self.storm = storm if port else ref_storm
        self.errors = errors if port else ref_errors
        self.NOTEBOOK = (port_types if port else ref_types).NOTEBOOK


BOTH = (Pkg(False), Pkg(True))


def both(fn):
    want, got = (fn(pkg) for pkg in BOTH)
    assert got == want
    return got


def make_nb(name, ns="fleet", port=True):
    device = ({"gpu": {"accelerator": "h100-80gb", "gpus": 1}} if port
              else {"tpu": {"accelerator": "v5e", "topology": "1x1"}})
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": ns},
            "spec": {**device, "template": {"spec": {"containers": [
                {"name": "notebook", "image": "jupyter"}]}}}}


def test_chaos_schedule_equals_the_reference():
    """The same seed and the same call sequence: the same fault log on
    both packages, run after run."""
    def run(pkg):
        kube = pkg.Kube()
        kube.add_namespace("ns")
        chaos = pkg.Chaos(kube, pkg.storm(rate=0.3), seed=SEED)
        for i in range(40):
            try:
                chaos.create(make_nb(f"nb-{i}", "ns", pkg.Kube is FakeKube))
            except pkg.errors.ApiError:
                pass
            try:
                chaos.list(pkg.NOTEBOOK, "ns")
            except pkg.errors.ApiError:
                pass
        return (list(chaos.fault_log), dict(chaos.calls),
                [w[1:] for w in chaos.write_log])

    log = both(run)
    assert log == both(run)
    assert log[0], "a 30% storm over 80 calls must inject something"


def test_chaos_respects_verb_and_kind_selectors():
    def run(pkg):
        kube = pkg.Kube()
        kube.add_namespace("ns")
        chaos = pkg.Chaos(kube, [pkg.Fault(
            "503", 1.0, verbs=frozenset({"create"}),
            kinds=frozenset({"Notebook"}))], seed=1)
        chaos.create({"apiVersion": "v1", "kind": "Namespace",
                      "metadata": {"name": "other"}})
        listed = chaos.list(pkg.NOTEBOOK, "ns")
        with pytest.raises(pkg.errors.ServiceUnavailable):
            chaos.create(make_nb("nb", "ns", pkg.Kube is FakeKube))
        return listed, chaos.injected(), list(chaos.fault_log)

    assert both(run) == ([], 1, [("create", "503", "Notebook")])


def test_chaos_max_injections_bounds_a_fault():
    def run(pkg):
        kube = pkg.Kube()
        kube.add_namespace("ns")
        chaos = pkg.Chaos(kube, [pkg.Fault("500", 1.0, max_injections=2)],
                          seed=1)
        for _ in range(2):
            with pytest.raises(pkg.errors.InternalError):
                chaos.list(pkg.NOTEBOOK, "ns")
        return chaos.list(pkg.NOTEBOOK, "ns"), chaos.injected("500")

    assert both(run) == ([], 2)


def test_chaos_pause_stops_injection():
    def run(pkg):
        kube = pkg.Kube()
        kube.add_namespace("ns")
        chaos = pkg.Chaos(kube, [pkg.Fault("500", 1.0)], seed=1)
        with pytest.raises(pkg.errors.InternalError):
            chaos.list(pkg.NOTEBOOK, "ns")
        chaos.pause()
        out = chaos.list(pkg.NOTEBOOK, "ns")
        chaos.resume()
        with pytest.raises(pkg.errors.InternalError):
            chaos.list(pkg.NOTEBOOK, "ns")
        return out, chaos.injected()

    assert both(run) == ([], 2)


def test_watch_establishments_carry_the_shard_filter():
    """The wrapped list_with_rv and watch pass ``shard_filter`` on, and
    the establishment log records it."""
    kube = FakeKube()
    kube.add_namespace("ns")
    for i in range(8):
        kube.create(make_nb(f"nb-{i}", "ns"))
    chaos = ChaosKube(kube, [], seed=1)
    spec = "v1:4:1:self"
    items, _ = chaos.list_with_rv(NOTEBOOK, "ns", shard_filter=spec)
    want, _ = kube.list_with_rv(NOTEBOOK, "ns", shard_filter=spec)
    assert [o["metadata"]["name"] for o in items] == \
        [o["metadata"]["name"] for o in want]
    stop = threading.Event()
    stream = chaos.watch(NOTEBOOK, "ns", shard_filter=spec, stop=stop)
    first = next(iter(stream))
    stop.set()
    assert first[1]["metadata"]["name"] in {o["metadata"]["name"]
                                            for o in want}
    assert chaos.watch_establishments[-1]["shard_filter"] == spec


def test_notebook_storm_converges_with_no_dead_letter():
    """20 notebooks under the reference smoke storm's rates, the notebook
    controller and the culler (sharing its informer) on a ChaosKube, the
    kubelet on the healthy store: every notebook ready with exactly its
    children, the cache equal to the server, no dead letter, and the
    storm stormed."""
    n = 20
    kube = FakeKube()
    kube.add_namespace("fleet")
    chaos = ChaosKube(kube, storm(rate=0.08, max_injections=40), seed=SEED)
    ctrl = make_controller(chaos, use_istio=False)
    ctrl.workers = 4
    # A bounded backoff ceiling: a key that draws several faults in a
    # row retries within the wait, not after the 30 s default ceiling.
    ctrl.queue = make_workqueue(base_delay=0.05, max_delay=2.0)
    cull = culling.make_controller(
        chaos, notebook_informer=ctrl.informers[NOTEBOOK],
        prober=lambda url: [{"execution_state": "busy"}],
        idle_minutes=1e9, check_period_minutes=0.02)
    stop = threading.Event()

    def kubelet():
        acked = {}
        for _etype, sts in kube.watch(STATEFULSET, "fleet", stop=stop):
            name = sts["metadata"]["name"]
            replicas = deep_get(sts, "spec", "replicas", default=0)
            if acked.get(name) == replicas or not replicas:
                continue
            tmpl = deep_get(sts, "spec", "template")
            for i in range(replicas):
                try:
                    kube.create({
                        "apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": f"{name}-{i}",
                                     "namespace": "fleet",
                                     "labels": dict(deep_get(
                                         tmpl, "metadata", "labels",
                                         default={}) or {})},
                        "spec": deep_get(tmpl, "spec")})
                except errors.AlreadyExists:
                    pass
                try:
                    kube.set_pod_phase("fleet", f"{name}-{i}", "Running",
                                       ready=True)
                except errors.ApiError:
                    pass
            acked[name] = replicas

    thread = threading.Thread(target=kubelet, daemon=True)
    thread.start()
    ctrl.start(chaos)
    cull.start(chaos)
    try:
        for i in range(n):
            kube.create(make_nb(f"nb-{i:03d}"))

        def converged():
            ready = [nb for nb in kube.list(NOTEBOOK, "fleet")
                     if deep_get(nb, "status", "replicas", default=0)
                     and deep_get(nb, "status", "readyReplicas")
                     == deep_get(nb, "status", "replicas")]
            return len(ready) == n and ctrl.queue.pending() == 0

        deadline = time.monotonic() + WAIT_S
        while not converged() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert converged(), (f"unconverged under the storm: queue "
                             f"{ctrl.queue.pending()}, calls {chaos.calls}")
        chaos.pause()
        nbs = kube.list(NOTEBOOK, "fleet")
        stses = kube.list(STATEFULSET, "fleet")
        assert sorted(s["metadata"]["name"] for s in stses) == \
            sorted(nb["metadata"]["name"] for nb in nbs)
        assert sorted(s["metadata"]["name"]
                      for s in kube.list(SERVICE, "fleet")) == sorted(
            x for nb in nbs for x in (nb["metadata"]["name"],
                                      nb["metadata"]["name"] + "-workers"))
        informer = ctrl.informers[NOTEBOOK]
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            server = {nb["metadata"]["name"]: nb
                      for nb in kube.list(NOTEBOOK, "fleet")}
            if all(informer.get(k, "fleet") is not None
                   and dict(informer.get(k, "fleet")) == v
                   for k, v in server.items()):
                break
            time.sleep(0.05)
        for k, v in server.items():
            assert dict(informer.get(k, "fleet")) == v, k
        assert not ctrl.dead_letters and not cull.dead_letters
    finally:
        stop.set()
        cull.stop()
        ctrl.stop()
        thread.join(timeout=5)
    assert chaos.injected() > 0, "the storm never stormed"
