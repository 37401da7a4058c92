"""The port's wire codec (``kubeflow_tpu_torch/platform/k8s/codec.py``) and
its scanner (``platform/csrc/wirecodec.cc``) against ``json.loads`` and the
JAX package's codec and scanner, on the reference's cases
(``tests/ctrlplane/test_wirecodec.py``): the scanner's slices and identity
fields, escapes, duplicate keys, scalar metadata and malformed lines; the
three-way decode matrix (native, Python, reference); identity reads that
parse nothing and one materialization at admit; raw pass-through in
``encode`` and frozen views without a thaw; merge-patch parity and the
routing counts; the ``KF_WIRE_CODEC`` values; the shard filter carried
over the wire."""
import json
import random
import threading

import pytest

from kubeflow_tpu.platform import native as ref_native
from kubeflow_tpu.platform.k8s import codec as ref_codec
from kubeflow_tpu_torch.platform import native
from kubeflow_tpu_torch.platform.k8s import codec
from kubeflow_tpu_torch.platform.k8s.client import RestKubeClient
from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK, deep_get, freeze
from kubeflow_tpu_torch.platform.runtime import apply, metrics
from kubeflow_tpu_torch.platform.runtime.informer import Informer
from kubeflow_tpu_torch.platform.runtime.sharding import ShardFilter, shard_of
from kubeflow_tpu_torch.platform.testing.fake import FakeKube
from kubeflow_tpu_torch.platform.testing.httpkube import HttpKubeServer


@pytest.fixture(scope="module", autouse=True)
def engines():
    assert native.available(), f"port engine: {native.load_error()}"
    assert ref_native.available(), "the reference's library did not build"


def _nb(name, ns="user1", labels=None):
    md = {"name": name, "namespace": ns}
    if labels:
        md["labels"] = labels
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": md,
            "spec": {"template": {"spec": {"containers": [
                {"name": name, "image": "img"}]}}}}


def _line(etype="MODIFIED", obj=None) -> bytes:
    if obj is None:
        obj = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "nb-0", "namespace": "user1",
                            "resourceVersion": "42",
                            "labels": {"notebook-name": "nb"}},
               "spec": {"containers": [{"name": "nb", "image": "img"}]},
               "status": {"phase": "Running"}}
    return json.dumps({"type": etype, "object": obj},
                      separators=(",", ":")).encode()


# -- the scanner --------------------------------------------------------------


def test_scan_slices_match_json_loads_and_reference():
    line = _line()
    got = native.wire_scan_event(line)
    assert got == ref_native.wire_scan_event(line)
    evt = json.loads(line)
    assert got[0] == evt["type"]
    assert json.loads(got[1]) == evt["object"]
    assert json.loads(got[2]) == evt["object"]["metadata"]


def test_scanner_extracts_identity_fields():
    etype, _, _, name, ns, rv = native.wire_scanner()(_line())
    assert (etype, name, ns, rv) == ("MODIFIED", "nb-0", "user1", "42")


def test_escaped_name_is_not_extracted_but_readable():
    line = _line(obj={"metadata": {"name": 'a"b', "namespace": "user1"}})
    got = native.wire_scanner()(line)
    assert got == ref_native.wire_scanner()(line)
    _, _, meta, name, ns, _ = got
    assert name is None and ns == "user1"
    assert json.loads(meta)["name"] == 'a"b'


def test_duplicate_keys_last_wins_like_json_loads():
    line = (b'{"type":"ADDED","object":{"metadata":{"name":"first"},'
            b'"x":1},"object":{"metadata":{"name":"old","name":"new",'
            b'"namespace":"ns2"}}}')
    evt = json.loads(line)
    etype, obj, meta, name, ns, rv = native.wire_scanner()(line)
    assert json.loads(obj) == evt["object"]
    assert json.loads(meta) == evt["object"]["metadata"]
    assert (name, ns) == ("new", "ns2")
    assert (etype, obj, meta, name, ns, rv) == ref_native.wire_scanner()(line)


def test_scalar_metadata_is_demoted_to_the_slow_path():
    line = b'{"type":"ADDED","object":{"metadata":5,"spec":{}}}'
    etype, obj, meta = native.wire_scan_event(line)
    assert meta is None
    assert json.loads(obj) == {"metadata": 5, "spec": {}}


def test_error_event_status_object():
    status = {"kind": "Status", "apiVersion": "v1", "status": "Failure",
              "reason": "Expired", "code": 410,
              "message": "too old resource version: 5"}
    etype, obj, meta = native.wire_scan_event(_line("ERROR", status))
    assert etype == "ERROR" and meta is None
    assert json.loads(obj) == status


@pytest.mark.parametrize("bad", [
    b"",
    b"not json",
    b'{"object":{}}',
    b'{"type":"ADDED"}',
    b'{"type":5,"object":{}}',
    b'{"type":"ADDED","object":{}}trail',
    b'{"type":"ADDED","object":{"a":"unterminated}',
])
def test_scanner_rejects_malformed_lines(bad):
    with pytest.raises(native.NativeError) as got:
        native.wire_scan_event(bad)
    with pytest.raises(ref_native.NativeError) as want:
        ref_native.wire_scan_event(bad)
    assert str(got.value) == str(want.value)


def test_scanner_fuzz_against_json_loads_and_reference():
    rng = random.Random(18)

    def rand_value(depth=0):
        if depth > 2 or rng.random() < 0.35:
            return rng.choice([1, -7, 3.5, "plain", "with spaces", 'q"uote',
                               "back\\slash", "unié", "nl\nline", True,
                               False, None, [], {}, [1, "two", {"t": 3}]])
        return {f"k{i}": rand_value(depth + 1)
                for i in range(rng.randint(0, 4))}

    def rand_meta():
        md = {}
        if rng.random() < 0.9:
            md["name"] = rng.choice(["nb-0", "nb", 'we"ird', "unié", "a-b"])
        if rng.random() < 0.7:
            md["namespace"] = rng.choice(["user1", "user2"])
        if rng.random() < 0.7:
            md["resourceVersion"] = str(rng.randint(1, 10**6))
        if rng.random() < 0.5:
            md["labels"] = {"app": "notebook"}
        return md

    scan, ref_scan = native.wire_scanner(), ref_native.wire_scanner()
    for _ in range(300):
        obj = {"metadata": rand_meta(), "spec": rand_value(),
               "status": rand_value()}
        for sep in ((",", ":"), (", ", ": ")):
            line = json.dumps({"type": rng.choice(["ADDED", "MODIFIED",
                                                   "DELETED"]),
                               "object": obj}, separators=sep).encode()
            evt = json.loads(line)
            got = scan(line)
            assert got == ref_scan(line)
            etype, ob, mb, name, ns, rv = got
            assert etype == evt["type"]
            assert json.loads(ob) == evt["object"]
            md = evt["object"]["metadata"]
            assert json.loads(mb) == md
            for value, key in ((name, "name"), (ns, "namespace"),
                               (rv, "resourceVersion")):
                if value is not None:
                    assert value == md[key]


# -- the decode matrix --------------------------------------------------------


CORPUS = [
    _line(),
    _line("ADDED", _nb("nb", labels={"notebook-name": "nb"})),
    _line("DELETED", {"metadata": {"name": "gone"}}),
    _line("ERROR", {"kind": "Status", "apiVersion": "v1", "code": 410,
                    "status": "Failure", "reason": "Expired",
                    "message": "too old"}),
    _line(obj={"metadata": {"name": 'esc"aped', "namespace": "user1"},
               "spec": {"uni": "héllo", "n": 2**40}}),
    _line(obj={"metadata": {"name": "cluster-scoped"}}),
    json.dumps({"type": "MODIFIED",
                "object": {"metadata": {"name": "spaced"}}},
               separators=(", ", ": ")).encode(),
    b'{"object": {"metadata": {"name": "x"}}}',   # no type: the fallback
]


@pytest.mark.parametrize("line", CORPUS, ids=range(len(CORPUS)))
def test_three_way_decode_matrix(line):
    t_py, o_py = codec.decode_event(line, engine="python")
    t_nat, o_nat = codec.decode_event(line, engine="native")
    t_ref, o_ref = ref_codec.decode_event(line, engine="native")
    assert t_nat == t_py == t_ref
    assert o_nat == o_py
    assert codec.materialize(o_nat) == o_py == ref_codec.materialize(o_ref)
    # Either encode engine serializes a native decode to the same object.
    for engine in ("native", "python"):
        _, fresh = codec.decode_event(line, engine="native")
        assert json.loads(codec.encode(fresh, engine=engine)) == o_py
        assert json.loads(ref_codec.encode(o_py, engine=engine)) == o_py


def test_identity_reads_parse_nothing():
    before = codec.stats()
    _, obj = codec.decode_event(_line(), engine="native")
    m = obj["metadata"]
    assert (m.get("name"), m.get("namespace"), m.get("resourceVersion")) \
        == ("nb-0", "user1", "42")
    assert "name" in m and bool(m)
    assert not m.parsed and not obj.materialized
    after = codec.stats()
    assert after["materialize"] == before["materialize"]
    assert after["decode_native"] == before["decode_native"] + 1
    assert after["decode_python"] == before["decode_python"]


def test_other_metadata_read_parses_the_slice_not_the_body():
    _, obj = codec.decode_event(_line(), engine="native")
    assert obj["metadata"]["labels"] == {"notebook-name": "nb"}
    assert obj["metadata"].parsed and not obj.materialized


def test_materialize_once():
    before = codec.stats()["materialize"]
    _, obj = codec.decode_event(_line(), engine="native")
    doc = codec.materialize(obj)
    assert type(doc) is dict and doc["status"]["phase"] == "Running"
    assert codec.materialize(obj) is doc
    assert codec.stats()["materialize"] == before + 1


def test_lazy_meta_is_read_only_and_deep_gettable():
    _, obj = codec.decode_event(_line(), engine="native")
    assert deep_get(obj, "metadata", "labels", "notebook-name") == "nb"
    with pytest.raises(TypeError):
        obj["metadata"]["name"] = "other"


def test_informer_admit_materializes_once_and_drops_unparsed():
    """At the informer's admit boundary: an admitted delta is parsed once,
    one the admit filter drops is never parsed."""
    kube = FakeKube()
    kube.add_namespace("user1")
    inf = Informer(kube, NOTEBOOK,
                   admit=lambda o: o["metadata"]["name"] != "dropped")
    inf._relist()
    _, keep = codec.decode_event(_line("ADDED", _nb("kept")),
                                 engine="native")
    _, drop = codec.decode_event(_line("ADDED", _nb("dropped")),
                                 engine="native")
    before = codec.stats()["materialize"]
    inf._apply("ADDED", keep)
    inf._apply("ADDED", drop)
    assert codec.stats()["materialize"] == before + 1
    assert not drop.materialized and not drop["metadata"].parsed
    cached = inf.get("kept", "user1")
    assert cached["spec"]["template"]["spec"]["containers"][0]["image"] \
        == "img"
    assert inf.get("dropped", "user1") is None


def test_scan_failure_falls_back_to_python():
    line = b'{"object": {"metadata": {"name": "x"}}}'
    before = codec.stats()["decode_python"]
    assert codec.decode_event(line, engine="native") == \
        ("", {"metadata": {"name": "x"}})
    assert codec.stats()["decode_python"] == before + 1


def test_forced_native_without_the_library_uses_python(monkeypatch):
    monkeypatch.setattr(codec, "_tls", threading.local())
    monkeypatch.setattr(native, "wire_scanner", lambda: None)
    etype, obj = codec.decode_event(_line(), engine="native")
    assert etype == "MODIFIED" and type(obj) is dict


def test_encode_raw_pass_through_until_materialized():
    line = _line()
    raw = json.loads(line)["object"]
    _, obj = codec.decode_event(line, engine="native")
    before = codec.stats()
    assert codec.encode(obj) == json.dumps(raw, separators=(",", ":"))
    assert codec.stats()["encode_raw"] == before["encode_raw"] + 1
    codec.materialize(obj)
    assert json.loads(codec.encode(obj)) == raw
    assert codec.stats()["encode_raw"] == before["encode_raw"] + 1


def test_encode_frozen_view_without_thaw():
    doc = _nb("frozen")
    view = freeze(doc)
    assert codec.encode(view) == json.dumps(doc)
    assert json.loads(codec.encode(view)) == \
        json.loads(ref_codec.encode(doc))


# -- merge patch --------------------------------------------------------------


def _py_merge(current, desired):
    patch = apply._diff(current or {}, desired or {})
    return None if patch is apply._UNCHANGED else patch


MERGE_CASES = [
    ({}, {}),
    ({"a": 1}, {"a": 1}),
    ({"a": 1}, {"a": 2}),
    ({"a": 1, "b": 2}, {"a": 1}),
    ({"a": {"b": 1, "c": 2}}, {"a": {"b": 1}}),
    ({"a": [1, 2]}, {"a": [3]}),
    ({"m": {"x": 1}}, {"m": "scalar"}),
    ({"s": 'hé"llo'}, {"s": "wörld"}),
    ({"spec": {"containers": [{"name": "a"}]}},
     {"spec": {"containers": [{"name": "a"}, {"name": "b"}]},
      "status": {"phase": "Running"}}),
]


@pytest.mark.parametrize("cur,des", MERGE_CASES)
def test_merge_patch_native_equals_python_and_reference(cur, des):
    got = codec.merge_patch_native(cur, des)
    assert got == _py_merge(cur, des)
    assert got == ref_codec.merge_patch_native(cur, des)


def test_merge_patch_parity_fuzz():
    rng = random.Random(1806)

    def rand_doc(depth=0):
        if depth > 2 or rng.random() < 0.3:
            return rng.choice([1, "s", 3.5, [1, 2], "t", 7, "x"])
        return {f"k{i}": rand_doc(depth + 1)
                for i in range(rng.randint(0, 4))}

    for _ in range(120):
        cur = {"root": rand_doc(), "x": rand_doc()}
        des = {"root": rand_doc(), "y": rand_doc()}
        got = codec.merge_patch_native(cur, des)
        assert got == _py_merge(cur, des) == \
            ref_codec.merge_patch_native(cur, des)


def test_merge_patch_for_routes_native_and_counts():
    assert codec.engine_native()
    before = codec.stats()
    assert apply.merge_patch_for({"a": 1, "b": 2}, {"a": 2}) == \
        {"a": 2, "b": None}
    assert apply.merge_patch_for(freeze({"a": 1}), {"a": 1}) is None
    after = codec.stats()
    assert after["merge_native"] == before["merge_native"] + 2
    assert after["merge_python"] == before["merge_python"]


def test_merge_patch_for_counts_the_python_walk(monkeypatch):
    monkeypatch.setattr(codec, "engine_native", lambda: False)
    before = codec.stats()["merge_python"]
    assert apply.merge_patch_for({"a": 1}, {"a": 2}) == {"a": 2}
    assert codec.stats()["merge_python"] == before + 1


# -- the knob -----------------------------------------------------------------


@pytest.mark.parametrize("value,mode,is_native", [
    (None, "auto", True), ("auto", "auto", True),
    ("native", "native", True), ("python", "python", False),
    ("bogus", "auto", True)])
def test_wire_codec_knob(value, mode, is_native, monkeypatch):
    if value is None:
        monkeypatch.delenv("KF_WIRE_CODEC", raising=False)
    else:
        monkeypatch.setenv("KF_WIRE_CODEC", value)
    codec.reset_engine_cache()
    try:
        assert codec._knob_codec() == mode
        assert codec.engine_native() is is_native
    finally:
        monkeypatch.delenv("KF_WIRE_CODEC", raising=False)
        codec.reset_engine_cache()


# -- the shard filter over the wire ------------------------------------------


def _admissible(names, shards, num_shards=8, ns="user1"):
    return {n for n in names if shard_of(ns, n, num_shards) in shards}


def test_rest_client_carries_the_shard_filter_over_the_wire():
    kube = FakeKube()
    kube.add_namespace("user1")
    names = [f"nb-{i}" for i in range(16)]
    for n in names:
        kube.create(_nb(n))
    shards = frozenset({2, 6})
    spec = ShardFilter(8, shards, "self").spec()
    want = _admissible(names, shards)
    assert want and want != set(names)
    server = HttpKubeServer(kube).start()
    try:
        client = RestKubeClient(server.base_url, qps=0)
        assert client.supports_shard_filter
        got = {n["metadata"]["name"]
               for n in client.list(NOTEBOOK, "user1", shard_filter=spec)}
        assert got == want
        items, rv = client.list_with_rv(NOTEBOOK, "user1",
                                        shard_filter=spec)
        assert {n["metadata"]["name"] for n in items} == want
        assert rv == kube.list_with_rv(NOTEBOOK, "user1")[1]
        stop = threading.Event()
        seen = set()
        for etype, obj in client.watch(NOTEBOOK, "user1",
                                       shard_filter=spec, stop=stop):
            assert etype == "ADDED"
            seen.add(obj["metadata"]["name"])
            if len(seen) == len(want):
                stop.set()
                break
        assert seen == want
    finally:
        server.stop()


def test_informer_over_the_wire_subscribes_and_refilters():
    kube = FakeKube()
    kube.add_namespace("user1")
    names = [f"nb-{i}" for i in range(24)]
    for n in names:
        kube.create(_nb(n))
    cur = {"shards": frozenset({0, 1, 2, 3})}
    server = HttpKubeServer(kube).start()
    client = RestKubeClient(server.base_url, qps=0)
    inf = Informer(client, NOTEBOOK, admit=lambda o: shard_of(
        o["metadata"].get("namespace") or "", o["metadata"]["name"], 8)
        in cur["shards"])
    inf.shard_subscription = lambda: ShardFilter(8, cur["shards"],
                                                 "self").spec()
    inf.start()
    try:
        assert inf.wait_for_sync(10.0)
        want = _admissible(names, cur["shards"])
        assert {k[1] for k in inf.keys()} == want
        assert inf.events_seen == len(want) < len(names)
        page = metrics.render()
        assert 'informer_last_sync_age_seconds{kind="Notebook"}' in page
        assert 'informer_relist_duration_seconds_count{kind="Notebook"}' \
            in page
        cur["shards"] = frozenset({4, 5, 6, 7})
        inf.refilter()
        want2 = _admissible(names, cur["shards"])
        assert {k[1] for k in inf.keys()} == want2
        assert not (want2 & want)
    finally:
        inf.stop()
        server.stop()
