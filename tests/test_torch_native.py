"""The port's native engine (``kubeflow_tpu_torch/platform/native.py`` over
``platform/csrc/``) against the JAX package's library and against the
port's own Python engines.  The cases are the reference's
(``tests/ctrlplane/test_native.py``): patches, merge patches and the
canonical serializer equal byte for byte or object for object, the work
queue's scripted outcomes equal to the reference ``NativeWorkQueue``'s,
the packer's assignments equal on seeded length lists.  The engine must
build here: a test fails, never skips, when it does not."""
import copy
import json
import random
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubeflow_tpu.platform import native as ref_native
from kubeflow_tpu.platform.runtime import controller as ref_controller
from kubeflow_tpu.platform.testing.fake import _merge_patch as ref_merge
from kubeflow_tpu.platform.webhook import jsonpatch as ref_jsonpatch
from kubeflow_tpu_torch.data import packing
from kubeflow_tpu_torch.platform import native
from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK
from kubeflow_tpu_torch.platform.runtime import controller
from kubeflow_tpu_torch.platform.testing.fake import FakeKube, _merge_patch
from kubeflow_tpu_torch.platform.webhook import jsonpatch

REPO = Path(__file__).resolve().parents[1]
SEEDED = settings(max_examples=60, derandomize=True, deadline=None,
                  database=None,
                  suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(scope="module", autouse=True)
def engines():
    assert native.available(), f"port engine: {native.load_error()}"
    assert ref_native.available(), "the reference's library did not build"


# Documents shaped like pods, with escapes, unicode, nesting, arrays,
# numbers beyond int64 and null/bool transitions (the reference's).
DIFF_CASES = [
    ({}, {}),
    ({"a": 1}, {"a": 1}),
    ({"a": 1}, {"a": 2}),
    ({"a": 1}, {}),
    ({}, {"a": [1, 2, {"b": None}]}),
    ({"a": {"b": {"c": 1}}}, {"a": {"b": {"c": 2, "d": "x"}}}),
    ({"arr": [1, 2, 3]}, {"arr": [1, 2]}),
    ({"s": "héllo\n\"quoted\""}, {"s": "wörld/~tilde"}),
    ({"a/b": 1, "m~n": 2}, {"a/b": 3, "m~n": 2}),
    ({"x": True}, {"x": False}),
    ({"x": None}, {"x": 0}),
    ({"x": True}, {"x": 1}),
    ({"x": 1}, {"x": 1.0}),
    ({"x": 1}, {"x": True}),
    ({"big": 2**63}, {"big": 2**63 + 1}),
    ({"big": -(2**70)}, {"big": 2**70}),
    ({"metadata": {"name": "nb", "labels": {"app": "notebook"}},
      "spec": {"containers": [{"name": "main", "image": "torch:cuda",
                               "env": [{"name": "A", "value": "1"}]}]}},
     {"metadata": {"name": "nb",
                   "labels": {"app": "notebook", "gpu": "h100"},
                   "annotations": {"poddefault.kubeflow.org/gpu": "42"}},
      "spec": {"containers": [{
          "name": "main", "image": "torch:cuda",
          "env": [{"name": "A", "value": "1"},
                  {"name": "KFT_GPUS_PER_HOST", "value": "8"}],
          "resources": {"limits": {"nvidia.com/gpu": 8}}}],
          "nodeSelector": {"nvidia.com/gpu.product": "NVIDIA-H100"},
          "tolerations": [{"key": "nvidia.com/gpu",
                           "operator": "Exists"}]}}),
]

scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-2**70, 2**70),
    st.floats(allow_nan=False, allow_infinity=False, width=64),
    st.text(alphabet=st.characters(codec="utf-8",
                                   exclude_categories=["Cs"]),
            max_size=8))
documents = st.recursive(
    scalars,
    lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(st.text(alphabet="ab/~c\"é", max_size=4), inner,
                        max_size=4)),
    max_leaves=20)
objects = st.dictionaries(st.text(alphabet="abc/~", max_size=3), documents,
                          max_size=4)


@pytest.mark.parametrize("before,after", DIFF_CASES)
def test_create_patch_equals_reference_and_python(before, after):
    got = native.create_patch(before, after)
    assert got == ref_native.create_patch(before, after)
    assert got == jsonpatch.create_patch(before, after)
    assert got == ref_jsonpatch.create_patch(before, after)
    assert native.apply_patch(before, got) == after
    assert jsonpatch.apply_patch(before, got) == after


@SEEDED
@given(before=objects, after=objects)
def test_create_patch_seeded_documents(before, after):
    got = json.loads(native.create_patch_json(json.dumps(before),
                                              json.dumps(after)))
    assert got == json.loads(ref_native.create_patch_json(
        json.dumps(before), json.dumps(after)))
    assert got == jsonpatch.create_patch(before, after)


def test_apply_patch_ops_equal_reference():
    doc = {"a": {"b": [1, 2, 3]}, "keep": True}
    ops = [
        {"op": "add", "path": "/a/b/1", "value": 99},
        {"op": "add", "path": "/a/b/-", "value": 4},
        {"op": "replace", "path": "/keep", "value": False},
        {"op": "add", "path": "/new/nested", "value": "x"},
        {"op": "test", "path": "/a/b/0", "value": 1},
        {"op": "copy", "from": "/a/b/0", "path": "/copied"},
        {"op": "move", "from": "/a/b/2", "path": "/moved"},
        {"op": "remove", "path": "/a/b/0"},
    ]
    got = native.apply_patch(doc, ops)
    assert got == ref_native.apply_patch(doc, ops)
    assert got == jsonpatch.apply_patch(doc, ops)


@pytest.mark.parametrize("ops", [
    [{"op": "remove", "path": "/missing"}],
    [{"op": "replace", "path": "/missing", "value": 1}],
    [{"op": "test", "path": "/a", "value": 2}],
    [{"op": "bogus", "path": "/a"}],
])
def test_apply_patch_errors_of_the_same_kind(ops):
    with pytest.raises(native.NativeError) as got:
        native.apply_patch({"a": 1}, ops)
    with pytest.raises(ref_native.NativeError) as want:
        ref_native.apply_patch({"a": 1}, ops)
    assert str(got.value) == str(want.value)
    with pytest.raises(jsonpatch.PatchError):
        jsonpatch.apply_patch({"a": 1}, ops)


def test_create_patch_fast_routes_native():
    before = {"spec": {"containers": [{"name": "m"}]}}
    after = {"spec": {"containers": [{"name": "m"}],
                      "nodeSelector": {"nvidia.com/gpu.product": "H100"}}}
    n = jsonpatch.routes["native"]
    assert jsonpatch.create_patch_fast(before, after) == \
        jsonpatch.create_patch(before, after)
    assert jsonpatch.routes["native"] == n + 1


@SEEDED
@given(doc=objects)
def test_canonical_json_byte_equal_to_python_and_reference(doc):
    """Byte-equal to ``json.dumps``; equal to the reference library's
    bytes but for the form of a float, which the port's copy writes as
    Python's repr does (the reference's engine writes 30.0 as 3e+01:
    ``test_canonical_floats_follow_python_repr``)."""
    raw = json.dumps(doc)
    got = native.canonical_json(raw)
    ref = ref_native.canonical_json(raw)
    assert got == json.dumps(doc, separators=(",", ":"), ensure_ascii=False)
    assert json.loads(got) == json.loads(ref)
    if '.' not in got and 'e' not in got.lower():
        assert got == ref


def test_canonical_json_byte_equal_to_reference_without_floats():
    rng = random.Random(99)

    def rand_doc(depth=0):
        if depth > 2 or rng.random() < 0.35:
            return rng.choice([0, 1, -42, 2**40, 2**70, True, False, None,
                               "plain", 'q"uote', "back\\slash",
                               "nl\nline", "unié中", "", [1, 2, "three"],
                               {}])
        return {f"k{i}": rand_doc(depth + 1)
                for i in range(rng.randint(0, 4))}

    for _ in range(100):
        raw = json.dumps({"root": rand_doc(),
                          "arr": [rand_doc() for _ in range(3)]})
        assert native.canonical_json(raw) == ref_native.canonical_json(raw)


@pytest.mark.parametrize("value", [
    30.0, 1e16, 1.5e16, 1e-05, 1.5e-05, 0.0001, -0.0, 0.1, 2.5, 1e22,
    123456789012345678.0, 9999999999999998.0, 5e-324,
    1.7976931348623157e308])
def test_canonical_floats_follow_python_repr(value):
    raw = json.dumps([value])
    assert native.canonical_json(raw) == json.dumps([value],
                                                    separators=(",", ":"))
    assert json.loads(ref_native.canonical_json(raw)) == [value]


MERGE_CASES = [
    ({"a": 1}, {"a": 2}),
    ({"a": {"b": 1, "c": 2}}, {"a": {"b": None}}),
    ({"a": [1, 2]}, {"a": [3]}),
    ({"a": 1}, {"b": {"c": {"d": None, "e": 1}}}),
    ({"m": {"x": 1}}, {"m": "scalar"}),
    ({}, {"a": None}),
    ({"u": "ü", "n": 2**63 + 1}, {"u": "v", "big": 2**70}),
]


@pytest.mark.parametrize("target,patch", MERGE_CASES)
def test_merge_apply_equals_reference_and_python(target, patch):
    py = copy.deepcopy(target)
    _merge_patch(py, patch)
    ref = copy.deepcopy(target)
    ref_merge(ref, patch)
    got = native.merge_patch_apply(target, patch)
    assert got == py == ref
    assert got == ref_native.merge_patch_apply(target, patch)


def test_merge_create_round_trip_and_reference():
    # No literal nulls and no bools: RFC 7386 cannot store a null, and the
    # diff follows Python == where True == 1 (the reference's domain).
    rng = random.Random(7)

    def rand_doc(depth=0):
        if depth > 2 or rng.random() < 0.3:
            return rng.choice([1, "s", 3.5, [1, 2], "t"])
        return {f"k{i}": rand_doc(depth + 1)
                for i in range(rng.randint(0, 4))}

    for _ in range(50):
        before = {"root": rand_doc(), "x": rand_doc()}
        after = {"root": rand_doc(), "y": rand_doc()}
        patch = native.merge_patch_create(before, after)
        assert patch == ref_native.merge_patch_create(before, after)
        assert native.merge_patch_apply(before, patch) == after
        py = copy.deepcopy(before)
        _merge_patch(py, patch)
        assert py == after


def test_fake_kube_patch_takes_the_native_merge(monkeypatch):
    calls = []
    real = native.merge_patch_apply
    monkeypatch.setattr(native, "merge_patch_apply",
                        lambda d, p: calls.append(p) or real(d, p))
    kube = FakeKube()
    kube.add_namespace("ns")
    kube.create({
        "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
        "metadata": {"name": "nb", "namespace": "ns",
                     "annotations": {"a": "1", "b": "2"}},
        "spec": {"template": {"spec": {"containers": [{"name": "nb"}]}}},
    })
    kube.patch(NOTEBOOK, "nb",
               {"metadata": {"annotations": {"a": None, "c": "3"}}}, "ns")
    nb = kube.get(NOTEBOOK, "nb", "ns")
    ann = {k: v for k, v in nb["metadata"]["annotations"].items()
           if not k.startswith("kubeflow.org/trace")}
    assert ann == {"b": "2", "c": "3"}
    assert len(calls) == 1


# -- the work queue -----------------------------------------------------------


def _pair():
    """(reference, port) native queues and their Request types."""
    return ((ref_native.NativeWorkQueue(base_delay=0.01, max_delay=0.1),
             ref_controller.Request),
            (native.NativeWorkQueue(base_delay=0.01, max_delay=0.1),
             controller.Request))


def _both(script):
    outs = []
    for q, Request in _pair():
        try:
            outs.append(script(q, Request))
        finally:
            q.shut_down()
    ref, port = outs
    assert port == ref
    return port


def test_queue_dedup_and_order():
    def script(q, Request):
        r1, r2 = Request("ns", "a"), Request("ns", "b")
        q.add(r1)
        q.add(r1)
        q.add(r2, delay=0.05)
        out = [q.get(0.5), q.get(1.0), q.get(0.02)]
        return [None if r is None else r.name for r in out]

    assert _both(script) == ["a", "b", None]


def test_queue_immediate_add_preempts_delayed():
    def script(q, Request):
        r = Request("ns", "x")
        q.add(r, delay=5.0)
        q.add(r)
        t0 = time.monotonic()
        got = q.get(1.0)
        fast = time.monotonic() - t0 < 0.5
        return [got.name, fast, q.get(0.02)]

    assert _both(script) == ["x", True, None]


def test_queue_rate_limit_backoff_and_forget():
    def script(q, Request):
        r = Request("ns", "err")
        out = []
        q.add_rate_limited(r)
        out.append(q.get(1.0).name)
        q.done(r)
        out.append(q.failures(r))
        q.add_rate_limited(r)
        t0 = time.monotonic()
        out.append(q.get(1.0).name)
        out.append(time.monotonic() - t0 >= 0.01)
        q.done(r)
        q.forget(r)
        out.append(q.failures(r))
        q.add_rate_limited(r)
        out.append(q.get(1.0).name)
        q.done(r)
        return out

    assert _both(script) == ["err", 1, "err", True, 0, "err"]


def test_queue_per_key_exclusion():
    def name(r):
        return None if r is None else r.name

    def script(q, Request):
        r = Request("ns", "x")
        q.add(r)
        out = [name(q.get(0.5))]
        q.add(r)                      # parked while processing
        out += [name(q.get(0.05)), q.pending()]
        q.done(r)                     # the parked add fires now
        out.append(name(q.get(0.5)))
        q.done(r)
        return out

    got = _both(script)
    assert [got[0], got[1], got[3]] == ["x", None, "x"]


def test_queue_shutdown_unblocks_get():
    def script(q, Request):
        results = []
        t = threading.Thread(target=lambda: results.append(q.get(5.0)))
        t.start()
        time.sleep(0.05)
        q.shut_down()
        t.join(timeout=2.0)
        return [t.is_alive(), results]

    assert _both(script) == [False, [None]]


def test_queue_id_maps_stay_bounded():
    def script(q, Request):
        for i in range(200):
            r = Request("ns", f"nb-{i}")
            q.add(r)
            assert q.get(1.0) == r
            q.forget(r)
            q.done(r)
        return [len(q._to_id), len(q._from_id)]

    assert _both(script) == [0, 0]


def test_make_workqueue_returns_the_native_queue():
    q = controller.make_workqueue(name="native-test")
    try:
        assert isinstance(q, native.NativeWorkQueue)
        assert q.metrics is not None and q.metrics.name == "native-test"
    finally:
        q.shut_down()


# -- the loader ---------------------------------------------------------------


def test_loaded_never_builds(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "_try_build",
                        lambda: calls.append(1) or False)
    monkeypatch.setattr(native, "build",
                        lambda *a, **k: calls.append(2))
    native.loaded()
    assert calls == []


@pytest.mark.parametrize("value,engine", [("0", "python"),
                                          ("1", "native"),
                                          ("bogus", "native")])
def test_kf_native_chooses_the_engines(value, engine, monkeypatch):
    """A process's first load reads KF_NATIVE: ``0`` leaves the Python
    engines serving, any other value keeps the default, the engine."""
    from kubeflow_tpu_torch.platform.k8s import codec
    from kubeflow_tpu_torch.platform.runtime import metrics

    monkeypatch.setenv("KF_NATIVE", value)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "_load_error", None)
    codec.reset_engine_cache()
    try:
        q = controller.make_workqueue()
        q.shut_down()
        gauge = metrics.native_engine_active.sample(component="workqueue")
        got = (type(q).__name__, codec.engine_native(), native.load_error(),
               gauge)
    finally:
        codec.reset_engine_cache()
        native._set_engine_gauge(True)
    if engine == "python":
        assert got == ("_WorkQueue", False, "disabled by KF_NATIVE=0", 0.0)
    else:
        assert got == ("NativeWorkQueue", True, None, 1.0)


def test_library_is_built_under_build_native_never_the_reference(tmp_path):
    assert native.LIB_PATH == REPO / "build" / "native" / "libkft_native.so"
    assert native.LIB_PATH.exists()
    cmds = native.compile_commands(tmp_path)
    for cmd in cmds:
        assert cmd[0] == "g++"
        assert {"-O2", "-std=c++17", "-fPIC", "-pthread"} <= set(cmd)
        assert not any("kubeflow_tpu/" in part for part in cmd)
    assert [Path(c[c.index("-c") + 1]).name for c in cmds[:-1]] == \
        list(native.SOURCES)
    assert "-shared" in cmds[-1]
    for name in native.SOURCES:
        assert (native.CSRC / name).parent == \
            REPO / "kubeflow_tpu_torch" / "platform" / "csrc"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/native/" in ignored


def test_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self, timeout=None):
            return "", None

    def run(cmd, **kw):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0, stdout="")

    monkeypatch.setattr(native.subprocess, "Popen", Proc)
    monkeypatch.setattr(native.subprocess, "run", run)
    lib = native.build(tmp_path)
    assert lib.read_bytes() == b"lib" and len(calls) == 5
    assert native.last_build_cached is False
    calls.clear()
    assert native.build(tmp_path) == lib and calls == []
    assert native.last_build_cached is True


# -- the packer ---------------------------------------------------------------


def test_native_pack_equals_reference_and_python_on_seeded_lists():
    rng = np.random.default_rng(20)
    for _ in range(200):
        row_len = int(rng.integers(8, 256))
        lengths = rng.integers(1, row_len + 1,
                               size=int(rng.integers(1, 64)))
        got = native.native_pack(lengths, row_len)
        ref = ref_native.native_pack(lengths, row_len)
        py = packing._pack_python(lengths.astype(np.int64), row_len)
        for a, b, c in zip(got[:2], ref[:2], py[:2]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert got[2] == ref[2] == py[2]
        # The port's entry point takes the engine.
        out = packing.pack_documents(lengths, row_len)
        np.testing.assert_array_equal(out[0], got[0])


def test_native_pack_refuses_bad_lengths():
    with pytest.raises(ValueError):
        native.native_pack(np.array([0, 3]), 8)
    with pytest.raises(ValueError):
        native.native_pack(np.array([9]), 8)


def test_packing_takes_a_loaded_engine_and_never_builds():
    """In a fresh process, packing runs the Python packer and neither
    builds nor loads the engine, nor imports the control plane; once the
    process has loaded the engine, packing takes it, with the same
    assignment."""
    code = textwrap.dedent("""
        import subprocess, sys
        def refuse(*a, **k):
            raise AssertionError("packing started a process")
        subprocess.Popen = subprocess.run = refuse
        from kubeflow_tpu_torch.data import packing
        from kubeflow_tpu_torch.platform import native
        lengths = [5, 3, 8, 1, 7, 2]
        py = packing.pack_documents(lengths, 8)
        assert not native.loaded() and native.last_build_seconds is None
        heavy = [m for m in sys.modules if m.startswith(
            ("kubeflow_tpu_torch.platform.runtime",
             "kubeflow_tpu_torch.platform.controllers",
             "kubeflow_tpu_torch.platform.testing",
             "kubeflow_tpu_torch.platform.k8s"))]
        assert not heavy, heavy
        del subprocess.Popen, subprocess.run
        import importlib; importlib.reload(subprocess)
        assert native.available(), native.load_error()
        calls, engine = [], native.native_pack
        native.native_pack = lambda *a: calls.append(a) or engine(*a)
        got = packing.pack_documents(lengths, 8)
        assert len(calls) == 1
        assert [a.tolist() for a in got[:2]] == [a.tolist() for a in py[:2]]
        assert got[2] == py[2]
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
