"""The port's sharded HA control plane (``kubeflow_tpu_torch/platform/
runtime/sharding.py``) against the reference's, each package on its own
``FakeKube``: the same operations, in the same order, go to both, and
the outcomes must be equal.

* the keyspace hash: ``stable_key_hash`` and ``shard_of`` bit-equal for
  10,000 seeded keys at 4 and 8 shards, uniform within 10 %, and every
  key owned by exactly one replica of a settled fleet;
* ``ShardFilter``: ``spec``/``parse`` strings and ``admits`` answers,
  Events by their involved object;
* the coordinator: one replica acquires everything, a join rebalances
  to fair share, a graceful stop hands over at once, a crash is absorbed
  after the TTL, the fencing token bumps on every ownership change and
  the Lease specs equal the reference's apart from times;
* fencing: a paused replica fences itself before writing, a stale but
  unclaimed lease confirms and writes, a write outside a reconcile
  passes unfenced, and the flight pool carries the fence context;
* the informer's admit filter, ``refilter`` and its token on a shared
  informer, and the server-side filter of ``FakeKube``; and, on the port
  alone, no event of a newly admitted range lost across a refilter
  (the reference's order can lose one);
* the metrics: ``controller_shard_owned`` and
  ``controller_lease_transitions_total`` in ``render()``, the gauge gone
  after ``stop``, and ``shard_map()`` with what ``/debug/shards`` serves.

The coordinator cases keep the reference's 0.5 s lease and 0.05 s
renew; every wait polls state and is bounded at 10 s."""
import copy
import random
import time
from collections import Counter

import pytest

from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.runtime import flight as ref_flight
from kubeflow_tpu.platform.runtime import informer as ref_informer
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.platform.runtime import sharding as ref_sharding
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu_torch.platform import FakeKube
from kubeflow_tpu_torch.platform.k8s import types as port_types
from kubeflow_tpu_torch.platform.runtime import flight as port_flight
from kubeflow_tpu_torch.platform.runtime import informer as port_informer
from kubeflow_tpu_torch.platform.runtime import metrics as port_metrics
from kubeflow_tpu_torch.platform.runtime import sharding

TTL = 0.5
RENEW = 0.05
SEED = 20260804


class Pkg:
    """One package's sharding module, fake API server and kinds."""

    def __init__(self, port):
        self.port = port
        self.sharding = sharding if port else ref_sharding
        self.Kube = FakeKube if port else RefKube
        self.types = port_types if port else ref_types
        self.Informer = (port_informer if port else ref_informer).Informer
        self.FlightPool = (port_flight if port else ref_flight).FlightPool
        self.metrics = port_metrics if port else ref_metrics

    def kube(self, *namespaces):
        kube = self.Kube()
        for ns in ("kubeflow",) + namespaces:
            kube.add_namespace(ns)
        return kube

    def coordinator(self, kube, ident, **kw):
        kw.setdefault("num_shards", 8)
        kw.setdefault("lease_seconds", TTL)
        kw.setdefault("renew_seconds", RENEW)
        return self.sharding.ShardCoordinator(kube, identity=ident, **kw)

    def render(self) -> str:
        out = self.metrics.render()
        return out.decode() if isinstance(out, bytes) else out


REF, PORT = Pkg(False), Pkg(True)


def both(fn):
    """``fn(pkg)`` on the reference and on the port; the port's outcome,
    once it equals the reference's."""
    want, got = fn(REF), fn(PORT)
    assert got == want
    return got


def notebook(name, ns="ns"):
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": ns}, "spec": {}}


# -- the keyspace hash ---------------------------------------------------------


def seeded_keys(n, seed=SEED):
    """``n`` (namespace, name) keys from a seeded generator: DNS-shaped
    names, some with digits and dashes, a few non-ASCII to exercise the
    utf-8 bytes."""
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz0123456789-"
    keys = []
    for i in range(n):
        ns = "".join(rng.choice(alphabet[:26]) for _ in range(rng.randint(1, 12)))
        name = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 40)))
        if i % 97 == 0:
            name += "-ñé"
        keys.append((ns, name))
    return keys


@pytest.mark.parametrize("num_shards", [4, 8])
def test_shard_of_is_bit_equal_to_the_reference(num_shards):
    keys = seeded_keys(10_000)
    for ns, name in keys:
        assert sharding.stable_key_hash(ns, name) == \
            ref_sharding.stable_key_hash(ns, name), (ns, name)
        assert sharding.shard_of(ns, name, num_shards) == \
            ref_sharding.shard_of(ns, name, num_shards), (ns, name)
    # The reference's pinned values.
    assert sharding.stable_key_hash("user1", "nb-0001") == 1726504714
    assert sharding.stable_key_hash("", "x") == 1473376466
    assert sharding.shard_of("team-a", "my-notebook", 8) == 5
    # Uniform within 10 % over the fleet-shaped keys the reference uses
    # and over the seeded ones.
    for sample in ([(f"ns{i % 7}", f"nb-{i:05d}") for i in range(10_000)],
                   keys):
        counts = Counter(sharding.shard_of(ns, name, num_shards)
                         for ns, name in sample)
        expected = len(sample) / num_shards
        assert set(counts) == set(range(num_shards))
        for shard, n in counts.items():
            assert abs(n - expected) / expected < 0.10, (shard, n)


def test_every_key_owned_by_exactly_one_replica():
    """A settled three-replica map is a partition: every key is owned by
    exactly one coordinator, on both packages alike."""
    keys = [(f"ns{i % 13}", f"nb-{i:05d}") for i in range(5_000)]

    def run(pkg):
        kube = pkg.kube()
        cs = [pkg.coordinator(kube, f"r{i}") for i in range(3)]
        for _ in range(3):
            for c in cs:
                c._tick()
        owners = []
        for ns, name in keys:
            mine = [i for i, c in enumerate(cs) if c.owns_key(ns, name)]
            assert len(mine) == 1, (ns, name, mine)
            owners.append(mine[0])
        return [sorted(c.owned()) for c in cs], owners

    owned, _ = both(run)
    assert sorted(s for o in owned for s in o) == list(range(8))


# -- the shard filter ----------------------------------------------------------

SPECS = [
    "v1:8:0,3,5:self", "v1:4::self", "v1:8:1:label=notebook-name",
    "v1:8:2,7:owner=Notebook", "v1:8:0,1,2,3:involved", None, "",
    "v2:8:1:self", "v1:0:1:self", "v1:8:x:self", "v1:8:1:bogus",
    "v1:8:1", "v1:8:3,1,1:self",
]


def filter_objects():
    """Objects each source derives a key from, or fails open on."""
    objs = [notebook(f"nb-{i:03d}") for i in range(24)]
    for i in range(12):
        objs.append({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"nb-{i:03d}-0", "namespace": "ns",
                         "labels": {"notebook-name": f"nb-{i:03d}"}}})
        objs.append({
            "apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": {"name": f"nb-{i:03d}", "namespace": "ns",
                         "ownerReferences": [{
                             "kind": "Notebook", "name": f"nb-{i:03d}",
                             "controller": True}]}})
    for name in ("nb-001", "nb-002-0", "nb-003-s1", "nb-004-s1-0",
                 "nb-005-s", "nb-006-sx-1", "x", ""):
        objs.append({"apiVersion": "v1", "kind": "Event",
                     "metadata": {"name": f"{name}.1", "namespace": "ns"},
                     "involvedObject": {"kind": "Pod", "name": name}})
    objs.append({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "bare", "namespace": "ns"}})
    objs.append({"apiVersion": "v1", "kind": "Event",
                 "metadata": {"name": "e", "namespace": "ns"}})
    return objs


def test_shard_filter_equals_the_reference():
    objs = filter_objects()
    for spec in SPECS:
        ref, port = (ref_sharding.ShardFilter.parse(spec),
                     sharding.ShardFilter.parse(spec))
        assert (ref is None) == (port is None), spec
        if ref is None:
            continue
        assert port.spec() == ref.spec()
        assert (port.num_shards, port.shards, port.source) == \
            (ref.num_shards, ref.shards, ref.source)
        assert [port.admits(o) for o in objs] == \
            [ref.admits(o) for o in objs], spec
    # Events by their involved object: the ordinal- and slice-stripped
    # candidates, and fail-open without a name.
    ev = next(o for o in objs if o["metadata"]["name"] == "nb-004-s1-0.1")
    cands = sharding.ShardFilter._involved_candidates(ev)
    assert cands == ["nb-004-s1-0", "nb-004-s1", "nb-004"]
    assert cands == ref_sharding.ShardFilter._involved_candidates(ev)
    nameless = sharding.ShardFilter(8, frozenset(), "involved")
    assert nameless.admits(objs[-1])


def test_fake_kube_filters_list_and_watch_as_the_reference():
    """The server-side filter: a ranged list and a filtered watch carry
    the same objects as the reference's, and the ranged list's
    resourceVersion stays global."""
    spec = "v1:4:0,2:self"

    def run(pkg):
        kube = pkg.kube("ns")
        for i in range(12):
            kube.create(notebook(f"nb-{i:02d}"))
        NB = pkg.types.NOTEBOOK
        items, rv = kube.list_with_rv(NB, "ns", shard_filter=spec)
        _, full_rv = kube.list_with_rv(NB, "ns")
        stream = kube.watch(NB, "ns", resource_version="0",
                            shard_filter=spec)
        seen = []
        for i in range(12, 16):
            kube.create(notebook(f"nb-{i:02d}"))
        want = {f"nb-{i:02d}" for i in range(16)
                if pkg.sharding.shard_of("ns", f"nb-{i:02d}", 4) in (0, 2)}
        deadline = time.monotonic() + 10
        for _etype, obj in stream:
            seen.append(obj["metadata"]["name"])
            if set(seen) >= want or time.monotonic() > deadline:
                break
        return (sorted(o["metadata"]["name"] for o in items), rv == full_rv,
                sorted(set(seen)), pkg.Kube.supports_shard_filter)

    names, global_rv, seen, supports = both(run)
    assert global_rv and supports and names and set(names) <= set(seen)


# -- the coordinator protocol ----------------------------------------------------


def test_single_replica_acquires_everything():
    def run(pkg):
        a = pkg.coordinator(pkg.kube(), "a")
        a._tick()
        return sorted(a.owned())

    assert both(run) == list(range(8))


def test_join_rebalances_to_fair_share():
    def run(pkg):
        kube = pkg.kube()
        a, b = pkg.coordinator(kube, "a"), pkg.coordinator(kube, "b")
        steps = []
        for c in (a, b, a, b, a, b):
            c._tick()
            steps.append((sorted(a.owned()), sorted(b.owned())))
        return steps

    steps = both(run)
    assert steps[0] == (list(range(8)), [])
    assert steps[1] == (list(range(8)), [])
    assert steps[2] == ([0, 1, 2, 3], [])
    assert steps[3] == steps[4] == steps[5] == ([0, 1, 2, 3], [4, 5, 6, 7])


def test_graceful_stop_hands_over_at_once():
    def run(pkg):
        kube = pkg.kube()
        a, b = pkg.coordinator(kube, "a"), pkg.coordinator(kube, "b")
        for c in (a, b, a, b):
            c._tick()
        before = (sorted(a.owned()), sorted(b.owned()))
        a.stop()
        b._tick()
        return before, sorted(b.owned())

    before, after = both(run)
    assert before == ([0, 1, 2, 3], [4, 5, 6, 7])
    assert after == list(range(8))


def test_crash_is_absorbed_after_the_ttl():
    def run(pkg):
        kube = pkg.kube()
        a, b = pkg.coordinator(kube, "a"), pkg.coordinator(kube, "b")
        for c in (a, b, a, b):
            c._tick()
        a.crash()
        b._tick()
        early = sorted(b.owned())
        time.sleep(TTL + 0.1)
        b._tick()
        crashed = sorted(s for s, act, _, _ in a.ownership_log
                         if act == "crash")
        return early, sorted(b.owned()), crashed

    early, late, crashed = both(run)
    assert early == [4, 5, 6, 7], "no takeover before the TTL"
    assert late == list(range(8)) and crashed == [0, 1, 2, 3]


def lease_specs(kube, types):
    """Every Lease's spec without its times, by name."""
    out = {}
    for lease in kube.list(types.LEASE, "kubeflow"):
        spec = {k: v for k, v in lease["spec"].items()
                if k not in ("acquireTime", "renewTime")}
        out[lease["metadata"]["name"]] = spec
    return out


def test_fencing_token_bumps_and_leases_equal_the_reference():
    """A scripted sequence (a join, a graceful stop, a crash and its
    absorption) leaves the same Leases on both servers, apart from
    times, and the fencing token bumps on every ownership change."""
    def run(pkg):
        kube = pkg.kube()
        a, b = pkg.coordinator(kube, "a", num_shards=4), \
            pkg.coordinator(kube, "b", num_shards=4)
        tokens, specs = [], []
        for step in ("a", "b", "a", "b", "stop-a", "b", "c-join",
                     "c", "b", "c", "crash-b", "ttl", "c"):
            if step == "a":
                a._tick()
            elif step == "b":
                b._tick()
            elif step == "stop-a":
                a.stop()
            elif step == "c-join":
                c = pkg.coordinator(kube, "c", num_shards=4)
            elif step == "c":
                c._tick()
            elif step == "crash-b":
                b.crash()
            elif step == "ttl":
                time.sleep(TTL + 0.1)
            tokens.append({name: [x.fence_token(s) for s in range(4)]
                           for name, x in (("a", a), ("b", b))})
            specs.append(lease_specs(kube, pkg.types))
        tokens.append({"c": [c.fence_token(s) for s in range(4)]})
        return tokens, specs

    tokens, specs = both(run)
    # A fresh create is epoch 0; every later holder change bumps it.
    assert tokens[0]["a"] == [0, 0, 0, 0]
    assert tokens[3]["b"] == [None, None, 1, 1]
    final = specs[-1]
    assert {f"kubeflow-tpu-ctrlplane-shard-{s}" for s in range(4)} <= \
        set(final)
    assert all(final[f"kubeflow-tpu-ctrlplane-shard-{s}"]["holderIdentity"]
               == "c" for s in range(4))
    assert all(t is not None and t >= 2 for t in tokens[-1]["c"])


class Recording:
    """A client whose write verbs are recorded before they go on."""

    WRITES = ("create", "update", "update_status", "patch", "patch_status",
              "delete")

    def __init__(self, inner):
        self._inner = inner
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self._inner, name)
        if name in self.WRITES:
            def wrapped(*args, **kw):
                self.calls.append(name)
                return fn(*args, **kw)
            return wrapped
        return fn


def test_paused_replica_fences_itself_before_writing():
    def run(pkg):
        kube = pkg.kube()
        a, b = pkg.coordinator(kube, "a"), pkg.coordinator(kube, "b")
        a._tick()
        rec = Recording(kube)
        fenced = pkg.sharding.FencedClient(rec, a)
        time.sleep(TTL + 0.1)          # a paused past its lease
        b._tick()
        believes = a.owns_key("ns", "x")
        pkg.sharding.set_current_request(("ns", "x"))
        try:
            with pytest.raises(pkg.sharding.FencingError):
                fenced.patch_status(pkg.types.NOTEBOOK, "x", {"status": {}},
                                    "ns")
        finally:
            pkg.sharding.set_current_request(None)
        return (sorted(b.owned()), believes, rec.calls, fenced.fenced_total,
                a.owns_shard(pkg.sharding.shard_of("ns", "x", 8)),
                [act for _, act, _, _ in a.ownership_log])

    owned_b, believes, calls, fenced_total, still, actions = both(run)
    assert owned_b == list(range(8)) and believes
    assert calls == [] and fenced_total == 1 and not still
    assert "fenced" in actions


def test_stale_but_unclaimed_lease_confirms_and_writes():
    def run(pkg):
        kube = pkg.kube("ns")
        a = pkg.coordinator(kube, "a")
        a._tick()
        time.sleep(TTL + 0.1)           # stale, but no contender
        fenced = pkg.sharding.FencedClient(kube, a, log_writes=True)
        pkg.sharding.set_current_request(("ns", "x"))
        try:
            fenced.create(notebook("x"))
        finally:
            pkg.sharding.set_current_request(None)
        return fenced.fenced_total, [
            {k: v for k, v in w.items() if k != "t"}
            for w in fenced.write_log]

    fenced_total, log = both(run)
    assert fenced_total == 0 and len(log) == 1
    assert log[0]["shard"] == sharding.shard_of("ns", "x", 8)
    assert log[0]["token"] == 0 and log[0]["key"] == "ns/x"


def test_writes_outside_a_reconcile_pass_unfenced():
    def run(pkg):
        kube = pkg.kube("ns")
        a = pkg.coordinator(kube, "a")  # owns nothing: never ticked
        fenced = pkg.sharding.FencedClient(kube, a, log_writes=True)
        fenced.create(notebook("free"))
        return [{k: v for k, v in w.items() if k != "t"}
                for w in fenced.write_log]

    log = both(run)
    assert log == [{"verb": "create", "kind": "Notebook", "namespace": "ns",
                    "name": "free"}]


def test_flight_pool_carries_the_fence_context():
    def run(pkg):
        pool = pkg.FlightPool(4, name="fence-test")
        seen = []
        pkg.sharding.set_current_request(("ns", "key-1"))
        try:
            pool.run([(lambda: seen.append(pkg.sharding.current_request()))
                      for _ in range(3)])
        finally:
            pkg.sharding.set_current_request(None)
        return seen

    assert both(run) == [("ns", "key-1")] * 3


# -- the informer's shard filter ---------------------------------------------------


def test_informer_admit_filter_and_refilter():
    def run(pkg):
        kube = pkg.kube("ns")
        for i in range(20):
            kube.create(notebook(f"nb-{i:02d}"))
        owned = {0, 1}

        def admit(obj):
            return pkg.sharding.shard_of(
                "ns", obj["metadata"]["name"], 4) in owned

        deltas = []
        informer = pkg.Informer(kube, pkg.types.NOTEBOOK, admit=admit)
        informer.add_handler(lambda et, obj: deltas.append(
            (et, obj["metadata"]["name"])))
        informer.start()
        assert informer.wait_for_sync(10.0)
        first = sorted(name for _, name in informer.keys("ns"))
        counts = (informer.events_seen >= 20,
                  informer.events_admitted < informer.events_seen)
        deltas.clear()
        owned.clear()
        owned.update({0, 2})
        dropped = informer.refilter()
        second = sorted(name for _, name in informer.keys("ns"))
        informer.stop()
        return first, counts, dropped, second, sorted(deltas)

    first, counts, dropped, second, deltas = both(run)
    assert counts == (True, True)
    assert first == sorted(f"nb-{i:02d}" for i in range(20) if
                           sharding.shard_of("ns", f"nb-{i:02d}", 4) in (0, 1))
    # The moved-out range leaves silently; only the moved-in one is ADDED.
    assert all(et == "ADDED" for et, _ in deltas)
    assert {n for _, n in deltas} == set(second) - set(first)
    assert dropped == len(set(first) - set(second))


def test_refilter_token_dedupes_a_shared_informer():
    def run(pkg):
        kube = pkg.kube("ns")
        kube.create(notebook("nb"))
        lists = []

        class Counting:
            def __init__(self, inner):
                self._inner = inner

            def list_with_rv(self, *a, **kw):
                lists.append(1)
                return self._inner.list_with_rv(*a, **kw)

            def __getattr__(self, name):
                return getattr(self._inner, name)

        informer = pkg.Informer(Counting(kube), pkg.types.NOTEBOOK,
                                admit=lambda o: True)
        informer._relist()
        base = len(lists)
        out = [informer.refilter(token=7), len(lists) - base]
        informer.refilter(token=7)      # the same event, a second sharer
        out.append(len(lists) - base)
        informer.refilter(token=8)      # a new event relists again
        out.append(len(lists) - base)
        return out

    assert both(run) == [0, 1, 1, 2]


def test_informer_subscription_rides_list_and_watch():
    """A subscription goes to a server that supports the filter, on the
    relist and on the watch, and a stale one re-establishes after a
    refilter: the stream then carries the new range's events."""
    def run(pkg):
        kube = pkg.kube("ns")
        calls = []

        class Spy:
            supports_shard_filter = True

            def list_with_rv(self, *a, **kw):
                calls.append(("list", kw.get("shard_filter")))
                return kube.list_with_rv(*a, **kw)

            def watch(self, *a, **kw):
                calls.append(("watch", kw.get("shard_filter")))
                return kube.watch(*a, **kw)

        owned = {0}
        informer = pkg.Informer(Spy(), pkg.types.NOTEBOOK,
                                admit=lambda o: pkg.sharding.shard_of(
                                    "ns", o["metadata"]["name"], 4) in owned)
        informer.shard_subscription = lambda: pkg.sharding.ShardFilter(
            4, frozenset(owned), "self").spec()
        informer.start()
        assert informer.wait_for_sync(10.0)
        owned.add(3)
        informer.refilter(relist=True)
        names = [f"nb-{i:02d}" for i in range(16)]
        for n in names:
            kube.create(notebook(n))
        want = {n for n in names
                if pkg.sharding.shard_of("ns", n, 4) in owned}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if {n for _, n in informer.keys("ns")} == want:
                break
            time.sleep(0.02)
        got = sorted(n for _, n in informer.keys("ns"))
        informer.stop()
        specs = sorted(set(calls))
        return got, specs

    got, specs = both(run)
    assert ("list", "v1:4:0,3:self") in specs
    assert ("watch", "v1:4:0,3:self") in specs
    assert ("list", "v1:4:0:self") in specs
    assert got == sorted(f"nb-{i:02d}" for i in range(16)
                         if sharding.shard_of("ns", f"nb-{i:02d}", 4)
                         in (0, 3))


@pytest.mark.parametrize("in_flight", ["newer", "older"])
def test_refilter_loses_no_event_of_a_new_range(in_flight):
    """A deliberate difference from the reference: a refilter breaks the
    watch under the informer's mutation lock, and what the broken stream
    still delivers is dropped, so the watch resumes from a version older
    than any event of the newly admitted range.  During the refilter's
    relist an object of the new range is created (the old subscription
    filters it out of the old stream), and an object of the old range:
    after it ("newer", the old stream's event in flight, which the
    reference would apply and resume from, skipping the new range's) or
    before it and modified ("older"); every object must reach the cache at
    the server's version."""
    kube = PORT.kube("ns")
    names = [f"nb-{i:02d}" for i in range(40)]
    old = next(n for n in names if sharding.shard_of("ns", n, 2) == 0)
    new = next(n for n in names if sharding.shard_of("ns", n, 2) == 1)
    owned, armed = {0}, []

    class Spy:
        supports_shard_filter = True

        def list_with_rv(self, *args, **kw):
            if armed and in_flight == "older":
                kube.create(notebook(old))
                obj = kube.get(PORT.types.NOTEBOOK, old, "ns")
                obj["spec"] = {"x": 1}
                kube.update(obj)
            out = kube.list_with_rv(*args, **kw)
            if armed:
                armed.clear()
                kube.create(notebook(new))
                if in_flight == "newer":
                    kube.create(notebook(old))
            return out

        def watch(self, *args, **kw):
            return kube.watch(*args, **kw)

    informer = PORT.Informer(
        Spy(), PORT.types.NOTEBOOK,
        admit=lambda o: sharding.shard_of(
            "ns", o["metadata"]["name"], 2) in owned)
    informer.shard_subscription = lambda: sharding.ShardFilter(
        2, frozenset(owned), "self").spec()
    informer.start()
    try:
        assert informer.wait_for_sync(10.0)
        owned.add(1)
        armed.append(True)
        informer.refilter(relist=True)

        def versions():
            return {n: informer.get(n, "ns")["metadata"]["resourceVersion"]
                    for _, n in informer.keys("ns")}

        want = {n: kube.get(PORT.types.NOTEBOOK, n, "ns")["metadata"][
            "resourceVersion"] for n in (old, new)}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and versions() != want:
            time.sleep(0.02)
        assert versions() == want
    finally:
        informer.stop()


# -- the metrics -----------------------------------------------------------------


def owned_lines(text, controller):
    return sorted(
        line for line in text.splitlines()
        if line.startswith(f'controller_shard_owned{{controller='
                           f'"{controller}"'))


def test_shard_metrics_and_shard_map():
    """controller_shard_owned rides render() while the coordinator runs
    and is gone after stop; the lease counter carries acquire and renew;
    shard_map() holds what /debug/shards serves."""
    def run(pkg):
        name = f"shard-metrics-{'port' if pkg.port else 'ref'}"
        kube = pkg.kube()
        a = pkg.coordinator(kube, "a", num_shards=4, name=name)
        lt = pkg.metrics.controller_lease_transitions_total

        def sample(reason):
            if pkg.port:
                return lt.sample(controller=name, reason=reason) or 0
            return lt.labels(controller=name, reason=reason)._value.get()

        a.start()
        try:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and (
                    len(a.owned()) < 4 or sample("renew") < 4):
                time.sleep(0.02)
            lines = [ln.replace(name, "X").replace(" 1.0", " 1")
                     for ln in owned_lines(pkg.render(), name)]
            page = {"identity": a.identity, "num_shards": a.num_shards,
                    "owned": sorted(a.owned()),
                    "shards": {str(k): {"holder": v.get("holder"),
                                        "owned_by_me": v["owned_by_me"]}
                               for k, v in sorted(a.shard_map().items())}}
        finally:
            a.stop()
        gone = owned_lines(pkg.render(), name)
        return (lines, page, gone, sample("acquire"), sample("renew") >= 4,
                sample("release"), sample("fenced"))

    lines, page, gone, acquired, renewed, released, fenced = both(run)
    assert lines == [f'controller_shard_owned{{controller="X",shard="{s}"}} 1'
                     for s in range(4)]
    assert page == {"identity": "a", "num_shards": 4, "owned": [0, 1, 2, 3],
                    "shards": {str(s): {"holder": "a", "owned_by_me": True}
                               for s in range(4)}}
    # The shutdown's release is not a rebalance's: neither package
    # counts it.
    assert gone == [] and acquired == 4 and renewed
    assert released == 0 and fenced == 0


def test_manager_refuses_shards_with_leader_election():
    from kubeflow_tpu_torch.platform import Manager

    kube = PORT.kube()
    with pytest.raises(ValueError):
        Manager(kube, leader_election=True,
                shards=PORT.coordinator(kube, "a"))


def test_server_filter_knob(monkeypatch):
    from kubeflow_tpu.platform.runtime import controller as ref_controller
    from kubeflow_tpu_torch.platform.runtime import controller

    for value, on in (("0", False), ("1", True), (None, True),
                      ("yes", True), ("2", True)):
        if value is None:
            monkeypatch.delenv("KF_SHARD_SERVER_FILTER", raising=False)
        else:
            monkeypatch.setenv("KF_SHARD_SERVER_FILTER", value)
        assert controller._server_filter_enabled() is on, value
        assert ref_controller._server_filter_enabled() is on, value


def test_lease_spec_shape_equals_the_reference():
    """The Lease a coordinator creates: the same keys and values apart
    from times, a sub-second TTL carried as a float and a TTL of a
    second or more as an int."""
    def run(pkg):
        out = []
        for ttl in (0.5, 2.0):
            kube = pkg.kube()
            a = pkg.coordinator(kube, "a", num_shards=1, lease_seconds=ttl)
            a._tick()
            out.append(copy.deepcopy(lease_specs(kube, pkg.types)))
        return out

    specs = both(run)
    shard = specs[0]["kubeflow-tpu-ctrlplane-shard-0"]
    assert shard == {"holderIdentity": "a", "leaseDurationSeconds": 0.5,
                     "leaseTransitions": 0}
    assert specs[1]["kubeflow-tpu-ctrlplane-shard-0"][
        "leaseDurationSeconds"] == 2
