"""The port's informer (``kubeflow_tpu_torch/platform/runtime/
informer.py``) against the reference's: the cases of
``tests/ctrlplane/test_informer.py`` (all but KFAM's cache reads and the
REST client's field-selector parameter, whose modules the port does not
have yet), each run on both packages' ``Informer`` over their own
``FakeKube`` with the same script.  The handlers see the same event
sequence ``(type, ns/name)``, the stores and index lists hold the same
objects, a watch failure, a replay, a resume from the collection's
resourceVersion and an ERROR relist end the same way.  Also the
cache-or-client reads' fallbacks."""
import queue as _queue
import time

import pytest

from kubeflow_tpu.platform.k8s import errors as ref_errors
from kubeflow_tpu.platform.k8s import types as ref_types
from kubeflow_tpu.platform.runtime import informer as ref_informer
from kubeflow_tpu.platform.runtime import metrics as ref_metrics
from kubeflow_tpu.platform.testing import FakeKube as RefKube
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s import types
from kubeflow_tpu_torch.platform.runtime import informer, metrics
from kubeflow_tpu_torch.platform.testing.fake import FakeKube


class World:
    def __init__(self, port):
        self.port = port
        self.kube = FakeKube() if port else RefKube()
        for ns in ("ns1", "ns2"):
            self.kube.add_namespace(ns)
        self.mod = informer if port else ref_informer
        self.types = types if port else ref_types
        self.errors = errors if port else ref_errors
        self.RB = self.types.ROLEBINDING

    def informer(self, **kw):
        return self.mod.Informer(self.kube, self.RB, **kw)

    def metrics_restarts(self):
        """informer_watch_restarts_total of RoleBindings."""
        if self.port:
            return metrics.informer_watch_restarts_total.sample(
                kind="RoleBinding") or 0
        return ref_metrics.registry.get_sample_value(
            "informer_watch_restarts_total", {"kind": "RoleBinding"}) or 0


def both(scenario):
    """``scenario(world)`` on the reference and on the port; both
    observations, which must be equal."""
    ref, port = scenario(World(False)), scenario(World(True))
    assert port == ref
    return port


def rb(name, ns, user="alice@x.org"):
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {"name": name, "namespace": ns,
                     "annotations": {"role": "edit", "user": user}},
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole", "name": "kubeflow-edit"},
    }


def _wait(predicate, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _names(objs):
    return sorted(f"{o['metadata']['namespace']}/{o['metadata']['name']}"
                  for o in objs)


def _recorder(seen):
    return lambda et, obj: seen.append(
        (et, f"{obj['metadata']['namespace']}/{obj['metadata']['name']}"))


def test_informer_seeds_then_tracks():
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        inf = w.informer().start()
        assert inf.wait_for_sync(5)
        out = [len(inf), inf.get("b1", "ns1") is not None]
        w.kube.create(rb("b2", "ns2"))
        assert _wait(lambda: inf.get("b2", "ns2") is not None)
        w.kube.delete(w.RB, "b1", "ns1")
        assert _wait(lambda: inf.get("b1", "ns1") is None)
        out += [_names(inf.list("ns2")), _names(inf.list()),
                sorted(inf.keys())]
        inf.stop()
        return out

    assert both(scenario)[:3] == [1, True, ["ns2/b2"]]


def test_informer_handlers_replay_and_stream():
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        inf = w.informer().start()
        inf.wait_for_sync(5)
        seen = []
        inf.add_handler(_recorder(seen))
        replay = list(seen)
        w.kube.create(rb("b2", "ns1"))
        b1 = w.kube.get(w.RB, "b1", "ns1")
        b1["metadata"]["annotations"]["role"] = "view"
        w.kube.update(b1)
        w.kube.delete(w.RB, "b2", "ns1")
        assert _wait(lambda: len(seen) >= 4)
        inf.stop()
        return replay, seen

    replay, seen = both(scenario)
    assert replay == [("ADDED", "ns1/b1")]
    assert seen == [("ADDED", "ns1/b1"), ("ADDED", "ns1/b2"),
                    ("MODIFIED", "ns1/b1"), ("DELETED", "ns1/b2")]


def test_informer_survives_watch_failure():
    def scenario(w):
        calls = {"n": 0}
        real_watch = w.kube.watch

        def flaky_watch(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("watch broke")
            return real_watch(*args, **kwargs)

        w.kube.watch = flaky_watch
        w.kube.create(rb("b1", "ns1"))
        inf = w.informer().start()
        assert inf.wait_for_sync(5)
        w.kube.create(rb("b2", "ns1"))
        assert _wait(lambda: inf.get("b2", "ns1") is not None, 10)
        out = [_names(inf.list()), calls["n"] >= 2]
        inf.stop()
        return out

    assert both(scenario) == [["ns1/b1", "ns1/b2"], True]


def test_informer_dedups_watch_replay():
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        inf = w.informer().start()
        inf.wait_for_sync(5)
        seen = []
        inf.add_handler(_recorder(seen))
        obj = w.kube.get(w.RB, "b1", "ns1")
        inf._apply("ADDED", obj)   # a replayed ADDED at the same version
        after_replay = list(seen)
        obj["metadata"]["annotations"]["role"] = "view"
        w.kube.update(obj)
        assert _wait(lambda: any(e == "MODIFIED" for e, _ in seen))
        inf.stop()
        return after_replay, seen

    after_replay, seen = both(scenario)
    assert after_replay == [("ADDED", "ns1/b1")]
    assert seen == [("ADDED", "ns1/b1"), ("MODIFIED", "ns1/b1")]


def test_informer_resumes_from_collection_rv():
    """The watch resumes from the LIST's collection resourceVersion, at
    least as new as a deleted object's (object versions miss deletes)."""
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        created = w.kube.create(rb("doomed", "ns1"))
        w.kube.delete(w.RB, "doomed", "ns1")
        inf = w.informer()
        rv = inf._relist()
        assert rv is not None
        assert int(rv) >= int(created["metadata"]["resourceVersion"])
        return rv, _names(inf.list())

    assert both(scenario)[1] == ["ns1/b1"]


def test_informer_error_event_forces_relist():
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        relists = []
        orig = w.kube.list_with_rv

        def counting_list_with_rv(*a, **k):
            relists.append(1)
            return orig(*a, **k)

        w.kube.list_with_rv = counting_list_with_rv
        events = _queue.Queue()
        events.put(("ERROR", {"kind": "Status", "code": 410}))
        real_watch = w.kube.watch

        def watch_with_error(*args, stop=None, **kwargs):
            try:
                yield events.get_nowait()
            except _queue.Empty:
                yield from real_watch(*args, stop=stop, **kwargs)

        w.kube.watch = watch_with_error
        restarts = w.metrics_restarts()
        inf = w.informer().start()
        assert inf.wait_for_sync(5)
        assert _wait(lambda: len(relists) >= 2)
        w.kube.create(rb("b2", "ns1"))
        assert _wait(lambda: inf.get("b2", "ns1") is not None)
        out = [len(relists), _names(inf.list()),
               w.metrics_restarts() - restarts]
        inf.stop()
        return out

    assert both(scenario) == [2, ["ns1/b1", "ns1/b2"], 1]


def _user_index(obj):
    u = obj["metadata"].get("annotations", {}).get("user")
    ns = obj["metadata"].get("namespace", "")
    return [f"{ns}/{u}"] if u else []


def test_index_list_tracks_adds_moves_and_deletes():
    def scenario(w):
        inf = w.informer(indexers={"user": _user_index}).start()
        assert inf.wait_for_sync()
        for name, user in (("b1", "alice@x.org"), ("b2", "alice@x.org"),
                           ("b3", "bob@x.org")):
            w.kube.create(rb(name, "ns1", user=user))
        assert _wait(lambda: len(
            inf.index_list("user", "ns1/alice@x.org")) == 2)
        out = [_names(inf.index_list("user", "ns1/alice@x.org")),
               _names(inf.index_list("user", "ns1/bob@x.org")),
               inf.index_list("user", "ns1/nobody@x.org")]
        b1 = w.kube.get(w.RB, "b1", "ns1")
        b1["metadata"]["annotations"]["user"] = "bob@x.org"
        w.kube.update(b1)   # moves b1 between index values
        assert _wait(lambda: len(
            inf.index_list("user", "ns1/bob@x.org")) == 2)
        out += [_names(inf.index_list("user", "ns1/alice@x.org")),
                _names(inf.index_list("user", "ns1/bob@x.org"))]
        w.kube.delete(w.RB, "b2", "ns1")
        assert _wait(lambda: inf.index_list("user", "ns1/alice@x.org") == [])
        inf.stop()
        return out

    assert both(scenario) == [["ns1/b1", "ns1/b2"], ["ns1/b3"], [],
                              ["ns1/b2"], ["ns1/b1", "ns1/b3"]]


def test_index_survives_relist():
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        inf = w.informer(indexers={"user": _user_index}).start()
        assert inf.wait_for_sync()
        out = [_names(inf.index_list("user", "ns1/alice@x.org"))]
        w.kube.create(rb("b2", "ns1"))
        inf._relist()
        out.append(_names(inf.index_list("user", "ns1/alice@x.org")))
        inf.stop()
        return out

    assert both(scenario) == [["ns1/b1"], ["ns1/b1", "ns1/b2"]]


def test_index_list_results_are_read_only():
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        inf = w.informer(indexers={"user": _user_index}).start()
        assert inf.wait_for_sync()
        got = inf.index_list("user", "ns1/alice@x.org")[0]
        with pytest.raises(TypeError, match="read-only"):
            got["metadata"]["annotations"]["user"] = "evil@x.org"
        mine = w.types.thaw(got)   # the sanctioned write path
        mine["metadata"]["annotations"]["user"] = "evil@x.org"
        user = inf.index_list("user", "ns1/alice@x.org")[0][
            "metadata"]["annotations"]["user"]
        inf.stop()
        return user

    assert both(scenario) == "alice@x.org"


def test_stopped_informer_is_not_restartable():
    def scenario(w):
        inf = w.informer().start()
        assert inf.wait_for_sync()
        assert inf.start() is inf   # idempotent while running
        inf.stop()
        with pytest.raises(RuntimeError, match="not restartable"):
            inf.start()
        return inf.has_synced

    assert both(scenario) is True


def test_cache_or_client_reads_fall_back_as_the_reference():
    """Synced cache: the cache.  No cache or unsynced: the client.  A
    transient client failure: the cache, flagged degraded; a degraded
    miss and a hard error raise."""
    def scenario(w):
        w.kube.create(rb("b1", "ns1"))
        inf = w.informer().start()
        assert inf.wait_for_sync()
        out = [_names(w.mod.cache_or_client_list(inf, w.kube, w.RB, "ns1")),
               _names(w.mod.cache_or_client_list(None, w.kube, w.RB)),
               w.mod.cache_or_client_get(None, w.kube, w.RB, "nope", "ns1")]
        unsynced = w.informer()

        class Down:
            def __init__(self, exc):
                self.exc = exc

            def list(self, *a, **k):
                raise self.exc

            get = list

        flagged = []
        down = Down(w.errors.ServiceUnavailable("down"))
        inf._synced.clear()   # a warm cache that lost its sync
        out.append(_names(w.mod.cache_or_client_list(
            inf, down, w.RB, "ns1", on_degraded=flagged.append)))
        out.append(w.mod.cache_or_client_get(
            inf, down, w.RB, "b1", "ns1",
            on_degraded=flagged.append)["metadata"]["name"])
        out.append(len(flagged))
        for call in (
                lambda: w.mod.cache_or_client_list(unsynced, down, w.RB),
                lambda: w.mod.cache_or_client_get(inf, down, w.RB, "x",
                                                  "ns1"),
                lambda: w.mod.cache_or_client_list(
                    inf, Down(w.errors.Forbidden("no")), w.RB)):
            with pytest.raises(w.errors.ApiError) as e:
                call()
            out.append(type(e.value).__name__)
        inf.stop()
        return out

    assert both(scenario) == [
        ["ns1/b1"], ["ns1/b1"], None, ["ns1/b1"], "b1", 2,
        "ServiceUnavailable", "ServiceUnavailable", "Forbidden"]


def test_running_informers_lists_started_and_not_stopped():
    kube = FakeKube()
    kube.add_namespace("ns1")
    inf = informer.Informer(kube, types.NOTEBOOK)
    assert inf not in metrics.running_informers()
    inf.start()
    try:
        assert inf.wait_for_sync(5)
        assert inf in metrics.running_informers()
    finally:
        inf.stop()
    assert inf not in metrics.running_informers()
