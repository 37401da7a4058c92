"""The port's sampling profiler (kubeflow_tpu_torch.telemetry.profiler)
against the reference's (kubeflow_tpu.telemetry.profiler): attribution
order, rotation and the folded format, truncation, overflow, the signed
diff and the capture, driven in both packages by the same fake clock,
thread names and synthetic stacks; then the port's own seams: the
sampler thread, the Tracer's active role, the slow dump's window and the
per-role sample counts kept inside the profiler."""
import contextlib
import sys
import threading
import types

import pytest

from kubeflow_tpu.telemetry import profiler as ref_prof
from kubeflow_tpu_torch.telemetry import profiler as port_prof
from kubeflow_tpu_torch.telemetry import trace as port_trace

BASE = 10 ** 15     # fake thread idents, far from any real one


def _stack(*frames):
    """A synthetic frame chain, root first: ("file.py", "fn") pairs."""
    frame = None
    for filename, name in frames:
        code = types.SimpleNamespace(co_filename=f"/src/pkg/{filename}",
                                     co_name=name)
        frame = types.SimpleNamespace(f_code=code, f_back=frame)
    return frame


# ident offset -> (thread name, stack)
THREADS = {
    1: ("llama3_8b-worker-3", (("threading.py", "_bootstrap"),
                               ("serve.py", "generate"),
                               ("generate.py", "decode_step"),
                               ("layers.py", "forward"))),
    2: ("Thread-12", (("threading.py", "_bootstrap"),
                      ("server.py", "serve_forever"),
                      ("selectors.py", "select"))),
    3: ("scheduler_loop_0-1", (("threading.py", "_bootstrap"),
                               ("scheduler.py", "_loop"),
                               ("scheduler.py", "_harvest"))),
    4: ("", (("threading.py", "_bootstrap"),)),
    5: ("train", (("run.py", "main"), ("loop.py", "train_loop"),
                  ("steps.py", "step"), ("llama.py", "forward"),
                  ("layers.py", "forward"), ("attention.py", "plain"))),
}


@contextlib.contextmanager
def synthetic(monkeypatch, threads):
    """sys._current_frames and threading.enumerate answer the synthetic
    threads while the block runs."""
    frames = {BASE + i: _stack(*st) for i, (_, st) in threads.items()}
    fakes = [types.SimpleNamespace(ident=BASE + i, name=name)
             for i, (name, _) in threads.items()]
    with monkeypatch.context() as m:
        m.setattr(sys, "_current_frames", lambda: dict(frames))
        m.setattr(threading, "enumerate", lambda: list(fakes))
        yield


def both(**kw):
    clock = [0.0]
    profs = (ref_prof.Profiler(now=lambda: clock[0], **kw),
             port_prof.Profiler(now=lambda: clock[0], **kw))
    return clock, profs


@pytest.mark.parametrize("ident,name,want", [
    (7, "Thread-3", "llama3_8b"),
    (8, "Thread-4", "fleet"),
    (9, "serve-worker-3", "serve-worker"),
    (9, "scrape_pool-0-1", "scrape_pool"),
    (9, "kft-profiler", "kft-profiler"),
    (9, "Thread-12", "unattributed"),
    (9, "Dummy-5", "unattributed"),
    (9, "", "unattributed"),
    (9, "-1", "unattributed"),
])
def test_attribution_order_matches_reference(ident, name, want):
    """active (the Tracer) -> static (registered) -> the thread name with
    trailing counters stripped -> unattributed."""
    active = {7: "llama3_8b"}
    static = {7: "pool", 8: "fleet"}
    assert port_prof.resolve_role(ident, name, active, static) == want
    assert ref_prof.resolve_role(ident, name, active, static) == want
    assert port_prof.UNATTRIBUTED == ref_prof.UNATTRIBUTED


def test_dead_threads_role_never_claims_a_recycled_ident():
    done = threading.Event()

    def register_and_exit():
        port_prof.register_thread_role("doomed-pool")
        port_prof.set_active_role("doomed-model")
        done.set()

    t = threading.Thread(target=register_and_exit, daemon=True)
    t.start()
    assert done.wait(10.0)
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert port_prof.resolve_role(t.ident, "fresh-worker-2") == "fresh-worker"
    assert port_prof.resolve_role(t.ident, "Thread-99") == "unattributed"


def test_rotation_and_folded_text_equal_reference(monkeypatch):
    clock, profs = both(hz=50.0, window_seconds=10.0, windows=3)
    ids = []
    with synthetic(monkeypatch, THREADS):
        for at in (0.0, 4.0, 9.0, 10.0, 12.0, 25.0, 31.0, 40.0, 52.0):
            clock[0] = at
            n = [p.sample_once() for p in profs]
            assert n[0] == n[1] == len(THREADS)
            ids.append([p.current_window_id() for p in profs])
            assert profs[0].folded() == profs[1].folded()
    assert all(a == b for a, b in ids)
    assert [i[0] for i in ids] == [1, 1, 1, 2, 2, 3, 3, 4, 5]
    assert profs[1].windows() == profs[0].windows()
    text = profs[1].folded()
    assert ("llama3_8b-worker;threading.py:_bootstrap;serve.py:generate;"
            "generate.py:decode_step;layers.py:forward 1") in text
    assert "unattributed;threading.py:_bootstrap 1" in text.splitlines()
    # The ring keeps the newest 3 closed windows; older ones are gone.
    for wid in range(1, 7):
        assert profs[1].folded(wid) == profs[0].folded(wid)
    assert profs[1].folded(1) is None and profs[1].folded(2) is not None
    assert profs[1].self_seconds() == profs[0].self_seconds()


@pytest.mark.parametrize("depth", [1, 2, 3, 24])
def test_truncation_equals_reference(monkeypatch, depth):
    _, profs = both(stack_depth=depth)
    with synthetic(monkeypatch, THREADS):
        for p in profs:
            p.sample_once()
    assert profs[1].folded() == profs[0].folded()
    deep = [ln for ln in profs[1].folded().splitlines()
            if ln.startswith("train;")]
    assert len(deep) == 1
    frames = deep[0].rsplit(" ", 1)[0].split(";")[1:]
    assert frames[-1] == "attention.py:plain"
    if depth < 6:
        assert frames[0] == "<truncated>" and len(frames) == depth + 1


def test_overflow_folds_into_other_like_reference(monkeypatch):
    _, profs = both(max_stacks=2)
    with synthetic(monkeypatch, THREADS):
        for p in profs:
            p.sample_once()
            p.sample_once()
    assert profs[1].folded() == profs[0].folded()
    assert "<other>" in profs[1].folded()


def _windows_into(p, stacks_by_window):
    for wid, stacks in stacks_by_window:
        w = (ref_prof if isinstance(p, ref_prof.Profiler)
             else port_prof).ProfileWindow(wid, 10.0 * wid)
        w.end = 10.0 * (wid + 1)
        w.stacks = dict(stacks)
        p._ring.append(w)


def test_diff_is_signed_and_equals_reference():
    windows = [(1, {("a", "x"): 5, ("a", "y"): 2, ("a", "same"): 3,
                    ("b", "q"): 1}),
               (2, {("a", "x"): 9, ("a", "z"): 3, ("a", "same"): 3,
                    ("b", "q"): 4})]
    _, profs = both()
    for p in profs:
        _windows_into(p, windows)
    for w1, w2 in ((1, 2), (2, 1), (1, 1), (1, 99)):
        assert profs[1].diff(w1, w2) == profs[0].diff(w1, w2)
    assert profs[1].diff(1, 2).splitlines() == [
        "a;x +4", "a;z +3", "b;q +3", "a;y -2"]
    assert profs[1].diff(1, 1) == ""
    assert profs[1].diff(1, 99) is None


def test_capture_equals_reference(monkeypatch):
    _, profs = both()
    with synthetic(monkeypatch, THREADS):
        got = [p.capture(0) for p in profs]
    assert got[1] == got[0]
    assert len(got[1].splitlines()) == len(THREADS)
    # The capture stays out of the windows.
    assert profs[1].windows() == []


def test_sampler_thread_runs_and_stops():
    p = port_prof.Profiler(hz=200.0, window_seconds=60.0)
    stop = threading.Event()
    spinner = threading.Thread(target=lambda: stop.wait(30),
                               name="live-spinner", daemon=True)
    spinner.start()
    p.start()
    try:
        for _ in range(1000):
            w = p.windows()
            if w and w[-1]["samples"] > 0:
                break
            stop.wait(0.01)
        assert p.windows()[-1]["samples"] > 0 and p.errors == 0
        assert any(ln.startswith("live-spinner;")
                   for ln in p.folded().splitlines())
        thread = p._thread
    finally:
        stop.set()
        spinner.join(timeout=10)
        p.stop()
    assert p._thread is None and not thread.is_alive()
    assert p.sampler_cpu_seconds > 0


def test_samples_are_counted_by_role_inside_the_profiler(monkeypatch):
    p = port_prof.Profiler(now=lambda: 0.0)
    with synthetic(monkeypatch, THREADS):
        p.sample_once()
        p.sample_once()
        p.capture(0)
    assert p.role_samples == {"llama3_8b-worker": 2, "unattributed": 4,
                              "scheduler_loop": 2, "train": 2}


@pytest.mark.parametrize("which", ["serve", "train"])
def test_tracer_sets_and_clears_the_active_role(which):
    """Tracer.begin points the thread's samples at the tracer's component
    (a serving model's name; ``train`` for the train loop's steps) and
    finish clears it; a disabled begin clears too."""
    from kubeflow_tpu_torch.telemetry import compute as ctel

    p = port_prof.Profiler(now=lambda: 0.0)
    tracer = (port_trace.Tracer("probe-model") if which == "serve"
              else ctel.train_tracer)
    role = tracer.component
    assert role == ("probe-model" if which == "serve" else "train")
    in_trace, release, cleared, done = (threading.Event() for _ in range(4))

    def run():
        tracer.begin("req")
        in_trace.set()
        release.wait(10)
        tracer.finish("ok")
        cleared.set()
        done.wait(10)

    t = threading.Thread(target=run, daemon=True)     # a Thread-N name
    t.start()
    try:
        assert in_trace.wait(10)
        p.sample_once()
        assert any(ln.startswith(role + ";")
                   for ln in p.folded().splitlines()), p.folded()
        release.set()
        assert cleared.wait(10)
        p.rotate()
        p.sample_once()
        assert not any(ln.startswith(role + ";")
                       for ln in p.folded().splitlines())
    finally:
        release.set()
        done.set()
        t.join(timeout=10)
    port_prof.set_active_role("stale")
    tracer.begin("req", enabled=False)
    assert port_prof.resolve_role(threading.get_ident(), "Thread-1") == (
        "unattributed")


def test_slow_dump_names_the_covering_window():
    p = port_prof.Profiler(now=lambda: 0.0)
    tracer = port_trace.Tracer("probe-slow")
    port_prof.register_debug_profiler(p)
    try:
        assert port_prof.debug_profiler() is p
        tracer.begin("req")
        d = tracer.finish("ok", slow_seconds=0.0)
        assert d["profile_window"] == p.current_window_id()
        tracer.begin("req")
        assert "profile_window" not in tracer.finish("ok", slow_seconds=60)
    finally:
        port_prof.register_debug_profiler(None)
    assert port_prof.covering_window_id() is None
    tracer.begin("req")
    assert "profile_window" not in tracer.finish("ok", slow_seconds=0.0)


def test_knob_defaults_equal_reference(monkeypatch):
    for name in ("KFT_PROFILE_HZ", "KFT_PROFILE_WINDOW_SECONDS",
                 "KFT_PROFILE_WINDOWS", "KFT_PROFILE_MAX_STACKS",
                 "KFT_PROFILE_STACK_DEPTH"):
        monkeypatch.delenv(name, raising=False)
    r, p = ref_prof.Profiler(), port_prof.Profiler()
    for attr in ("hz", "window_seconds", "max_stacks", "stack_depth"):
        assert getattr(p, attr) == getattr(r, attr), attr
    assert p._ring.maxlen == r._ring.maxlen
    monkeypatch.setenv("KFT_PROFILE_HZ", "19")
    monkeypatch.setenv("KFT_PROFILE_STACK_DEPTH", "5")
    r, p = ref_prof.Profiler(), port_prof.Profiler()
    assert p.hz == r.hz == 19.0 and p.stack_depth == r.stack_depth == 5
