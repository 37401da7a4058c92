"""The port's leader election (``kubeflow_tpu_torch/platform/runtime/
leader.py``), its ``Manager`` behind a Lease and the client's token
bucket, against the reference's: the seven cases of
``tests/ctrlplane/test_leader_election.py``, each on both packages over
their own ``FakeKube``.  The election rounds answer the same, and the
Lease's spec is the reference's but for identities and times.  Leases
and periods here are at most 2 s."""
import datetime
import time

import pytest

from kubeflow_tpu.platform.k8s import client as ref_client
from kubeflow_tpu.platform.runtime import Manager as RefManager
from kubeflow_tpu.platform.runtime.leader import LeaderElector as RefElector
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu_torch.platform import FakeKube, LeaderElector, Manager
from kubeflow_tpu_torch.platform.k8s import client
from kubeflow_tpu_torch.platform.k8s.types import LEASE

T0 = datetime.datetime(2026, 7, 30, 12, 0, 0, tzinfo=datetime.timezone.utc)
PACKAGES = {"reference": (RefKube, RefElector, RefManager),
            "port": (FakeKube, LeaderElector, Manager)}


class Clock:
    def __init__(self):
        self.now = T0

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += datetime.timedelta(seconds=seconds)


def kube_of(Kube):
    kube = Kube()
    kube.add_namespace("kubeflow")
    return kube


def lease_spec(kube, name="test-lease"):
    """The Lease's spec with its identity and times left out."""
    spec = dict(kube.get(LEASE, name, "kubeflow")["spec"])
    for k in ("holderIdentity", "acquireTime", "renewTime"):
        spec.pop(k)
    return spec


def rounds(package, script):
    """``script`` (a list of (elector, clock seconds to advance first))
    on two electors "a" and "b" of ``package``: each round's answer, the
    holder after it, and the Lease's spec after the last."""
    Kube, Elector, _ = PACKAGES[package]
    kube, clock = kube_of(Kube), Clock()
    electors = {ident: Elector(kube, name="test-lease", namespace="kubeflow",
                               identity=ident, lease_seconds=15, now=clock)
                for ident in "ab"}
    out = []
    for ident, advance, action in script:
        clock.advance(advance)
        if action == "release":
            electors[ident].release()
            answer = "released"
        else:
            answer = electors[ident].try_acquire_or_renew()
        holder = kube.get(LEASE, "test-lease", "kubeflow")["spec"][
            "holderIdentity"]
        out.append((ident, answer, holder))
    return out, lease_spec(kube)


SCRIPTS = {
    "exactly-one-acquires": [("a", 0, "try"), ("b", 0, "try"),
                             ("a", 5, "try"), ("b", 0, "try")],
    "expiry-failover": [("a", 0, "try"), ("b", 16, "try"), ("a", 0, "try")],
    "release-hands-over": [("a", 0, "try"), ("a", 0, "release"),
                           ("b", 0, "try")],
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_election_rounds_equal_the_reference(case):
    ref = rounds("reference", SCRIPTS[case])
    port = rounds("port", SCRIPTS[case])
    assert port == ref
    answers = [a for _, a, _ in port[0]]
    assert answers == {
        "exactly-one-acquires": ["leading", "lost", "leading", "lost"],
        "expiry-failover": ["leading", "leading", "lost"],
        "release-hands-over": ["leading", "released", "leading"],
    }[case]
    assert port[1]["leaseDurationSeconds"] == 15


def _await(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_manager_leader_election_single_writer(package):
    Kube, _, Mgr = PACKAGES[package]
    kube = kube_of(Kube)
    m1 = Mgr(kube, leader_election=True, identity="m1")
    m2 = Mgr(kube, leader_election=True, identity="m2")
    for m in (m1, m2):
        m.elector.lease_seconds = 1.0
        m.elector.renew_seconds = 0.05
        m.elector.retry_seconds = 0.05
    m1.start()
    assert _await(lambda: m1.is_leader)
    m2.start()
    time.sleep(0.2)
    assert not m2.is_leader
    assert m2.healthy()  # a standby is healthy, just not leading
    m1.stop()            # releases the lease: m2 takes over
    assert _await(lambda: m2.is_leader)
    holder = kube.get(LEASE, "kubeflow-tpu-controller-leader",
                      "kubeflow")["spec"]["holderIdentity"]
    m2.stop()
    assert holder == "m2"


@pytest.mark.parametrize("package", ["reference", "port"])
def test_token_bucket_limits_rate(package):
    TokenBucket = (ref_client if package == "reference"
                   else client).TokenBucket
    tb = TokenBucket(qps=200, burst=3)
    t0 = time.monotonic()
    for _ in range(3):
        tb.acquire()  # the burst: immediate
    assert time.monotonic() - t0 < 0.05
    for _ in range(4):
        tb.acquire()  # ~5 ms each at 200 qps
    assert time.monotonic() - t0 >= 4 / 200


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_transient_api_error_does_not_drop_leadership(package):
    """A failed renew demotes only once the lease duration has passed
    without a successful one (client-go's semantics)."""
    Kube, Elector, _ = PACKAGES[package]
    kube = kube_of(Kube)

    class Flaky:
        def __init__(self, inner):
            self._inner = inner
            self.fail = 0

        def __getattr__(self, name):
            fn = getattr(self._inner, name)

            def wrapped(*a, **k):
                if self.fail > 0 and name in ("get", "update", "create"):
                    self.fail -= 1
                    raise RuntimeError("apiserver blip")
                return fn(*a, **k)

            return wrapped

    flaky = Flaky(kube)
    el = Elector(kube, name="t", namespace="kubeflow", identity="a",
                 lease_seconds=2.0, renew_seconds=0.05, retry_seconds=0.05)
    el.client = flaky
    became, lost = [], []
    el.on_started_leading = lambda: became.append(1)
    el.on_stopped_leading = lambda: lost.append(1)
    el.start()
    assert _await(lambda: el.is_leader)
    flaky.fail = 3  # a few blips, well inside the 2 s lease
    time.sleep(0.5)
    assert el.is_leader and not lost
    el.stop()
    assert became == [1] and lost == [1]  # stop steps down once
    assert kube.get(LEASE, "t", "kubeflow")["spec"]["holderIdentity"] == ""


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_lost_leadership_is_terminal_for_manager(package):
    Kube, _, Mgr = PACKAGES[package]
    kube = kube_of(Kube)
    m = Mgr(kube, leader_election=True, identity="m")
    m.elector.lease_seconds = 0.4
    m.elector.renew_seconds = 0.05
    m.elector.retry_seconds = 0.05
    m.start()
    assert _await(lambda: m.is_leader)
    # Steal the lease: a live foreign holder is a definitive loss.
    lease = kube.get(LEASE, "kubeflow-tpu-controller-leader", "kubeflow")
    lease["spec"]["holderIdentity"] = "other"
    lease["spec"]["renewTime"] = "2199-01-01T00:00:00.000000Z"
    kube.update(lease)
    assert _await(lambda: not m.healthy())  # the liveness probe restarts us
    time.sleep(0.2)
    assert not m.is_leader                  # and we never re-contend
    m.stop()
