"""The always-on sampling profiler of a replica or a trainer, standard
library only: the port's copy of ``kubeflow_tpu/telemetry/profiler.py``.

A daemon thread walks ``sys._current_frames()`` at ``KFT_PROFILE_HZ``
(default 67 Hz) and folds every thread's stack into a bounded
``(thread_role, folded_stack) -> count`` aggregate per rotating window
(a ring of ``KFT_PROFILE_WINDOWS``).  Attribution joins each sampled
thread against, in order:

1. **active role**: set by ``telemetry/trace.py``'s ``Tracer`` on
   ``begin`` and cleared on ``finish``: the serving model of a request
   thread (``telemetry/serve.py``), ``train`` for a train step
   (``telemetry/compute.py``);
2. **static role**: a long-lived thread's role registered at creation
   (``register_thread_role``);
3. **thread name** with trailing ``-N``/``_N`` counters stripped;
   interpreter default names (``Thread-N``, ``Dummy-N``) fold to
   ``unattributed``.

Exports are folded-stack text (``role;frame;...;frame count`` a line,
root first), a signed window diff and a synchronous ``capture(seconds)``,
served at a replica's ``/debug/profile`` (``models/serve.py``, gated by
``DEBUG_TRACES``) from the profiler a caller registered with
``register_debug_profiler``, and at the controllers' health port
(``platform/main.py``).  Samples are counted per role in the control
plane's ``kft_profile_samples_total{role}`` (``platform/runtime/
metrics.py``, which also serves the scrape-time
``kft_profile_self_seconds{role}`` of the registered profiler) and in
``Profiler.role_samples``.
"""
from __future__ import annotations

import re
import sys
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform import config

# -- thread-role registries ---------------------------------------------------
#
# Module-level dicts keyed by thread ident, each entry carrying a
# weakref to the registering Thread; single-key reads and writes are
# GIL-atomic, and the sampler snapshots via :func:`_live_roles` before
# iterating.  ``_active_roles`` is the dynamic seam (Tracer-driven,
# cleared on finish); ``_static_roles`` is claimed once at thread
# creation.  The weakref matters: the OS recycles thread idents,
# so "claimed once, lives as long as the thread" must mean the THREAD,
# not the ident — a dead pool worker's entry must never re-attribute an
# unrelated new thread that inherited its ident (and a thread that died
# mid-trace must not leak its active role the same way).

_active_roles: Dict[int, Tuple["weakref.ref", str]] = {}
_static_roles: Dict[int, Tuple["weakref.ref", str]] = {}

_DEFAULT_THREAD_NAME = re.compile(r"^(Thread|Dummy)-\d+")
_NAME_COUNTERS = re.compile(r"([-_]\d+)+$")

UNATTRIBUTED = "unattributed"


def _thread_for(ident: Optional[int]) -> Optional[threading.Thread]:
    if ident is None or ident == threading.get_ident():
        return threading.current_thread()
    for t in threading.enumerate():
        if t.ident == ident:
            return t
    return None


def _live_roles(registry: Dict[int, Tuple["weakref.ref", str]]
                ) -> Dict[int, str]:
    """ident -> role for entries whose registering thread is still the
    live owner of that ident; dead/recycled entries are pruned."""
    live: Dict[int, str] = {}
    for ident, entry in list(registry.items()):
        t = entry[0]()
        if t is None or not t.is_alive() or t.ident != ident:
            # Conditional removal: a new thread re-registering the
            # recycled ident between our snapshot and this prune must
            # not lose its fresh entry.
            if registry.get(ident) is entry:
                registry.pop(ident, None)
        else:
            live[ident] = entry[1]
    return live


def register_thread_role(role: str, ident: Optional[int] = None) -> None:
    """Claim a stable role for a long-lived thread (call from the thread
    itself at creation, or pass its ident).  Pool workers claim their
    pool name here so ``Thread-N`` never defeats profile grouping."""
    t = _thread_for(ident)
    if t is not None and t.ident is not None:
        _static_roles[t.ident] = (weakref.ref(t), role)


def set_active_role(role: Optional[str], ident: Optional[int] = None) -> None:
    """Point the current thread's samples at ``role`` (the Tracer seam:
    the serving model, the train component).
    ``None`` clears, same as :func:`clear_active_role`."""
    if role is None:
        clear_active_role(ident)
        return
    t = _thread_for(ident)
    if t is not None and t.ident is not None:
        _active_roles[t.ident] = (weakref.ref(t), role)


def clear_active_role(ident: Optional[int] = None) -> None:
    _active_roles.pop(ident if ident is not None else threading.get_ident(),
                      None)


def _role_from_name(name: str) -> str:
    if not name or _DEFAULT_THREAD_NAME.match(name):
        return UNATTRIBUTED
    return _NAME_COUNTERS.sub("", name) or UNATTRIBUTED


def resolve_role(ident: int, name: str,
                 active: Optional[Dict[int, str]] = None,
                 static: Optional[Dict[int, str]] = None) -> str:
    """Attribution order: active (Tracer) → static (registered at
    creation) → thread name with trailing counters stripped →
    ``unattributed``."""
    role = (active if active is not None
            else _live_roles(_active_roles)).get(ident)
    if role is None:
        role = (static if static is not None
                else _live_roles(_static_roles)).get(ident)
    if role is None:
        role = _role_from_name(name)
    return role


# -- windows ------------------------------------------------------------------


class ProfileWindow:
    """One rotation's bounded ``(role, folded_stack) -> count``
    aggregate.  ``end`` is None while the window is still filling."""

    __slots__ = ("wid", "start", "end", "samples", "stacks")

    def __init__(self, wid: int, start: float):
        self.wid = wid
        self.start = start
        self.end: Optional[float] = None
        self.samples = 0
        self.stacks: Dict[Tuple[str, str], int] = {}

    def index_entry(self) -> dict:
        return {
            "window": self.wid,
            "start": round(self.start, 3),
            "end": None if self.end is None else round(self.end, 3),
            "samples": self.samples,
            "stacks": len(self.stacks),
        }


def _folded_lines(stacks: Dict[Tuple[str, str], int]) -> str:
    return "\n".join(
        f"{role};{stack} {count}"
        for (role, stack), count in sorted(stacks.items()))


class Profiler:
    """The always-on sampler.  Construct once per process, ``start()``,
    and register with :func:`register_debug_profiler`; tests drive
    ``sample_once``/``rotate`` directly with a fake clock."""

    OVERFLOW_FRAME = "<other>"
    TRUNCATED_FRAME = "<truncated>"

    def __init__(self, *, hz: Optional[float] = None,
                 window_seconds: Optional[float] = None,
                 windows: Optional[int] = None,
                 max_stacks: Optional[int] = None,
                 stack_depth: Optional[int] = None,
                 now=time.time):
        self.hz = float(hz if hz is not None else config.knob(
            "KFT_PROFILE_HZ", 67.0, float,
            doc="sampling profiler rate; the sampler thread walks "
                "sys._current_frames() this many times per second"))
        self.window_seconds = float(
            window_seconds if window_seconds is not None else config.knob(
                "KFT_PROFILE_WINDOW_SECONDS", 60.0, float,
                doc="profile window rotation period; /debug/profile?diff "
                    "compares two of these"))
        ring = int(windows if windows is not None else config.knob(
            "KFT_PROFILE_WINDOWS", 8, int,
            doc="closed profile windows kept in the ring (memory bound)"))
        self.max_stacks = int(max_stacks if max_stacks is not None
                              else config.knob(
            "KFT_PROFILE_MAX_STACKS", 512, int,
            doc="distinct (role, stack) aggregates per window; overflow "
                "folds into the per-role <other> bucket"))
        self.stack_depth = int(stack_depth if stack_depth is not None
                               else config.knob(
            "KFT_PROFILE_STACK_DEPTH", 24, int,
            doc="frames kept per sampled stack (leaf-most win; deeper "
                "stacks are marked <truncated> at the root)"))
        self._now = now
        self._lock = threading.Lock()
        self._wid = 0
        self._current: Optional[ProfileWindow] = None
        self._ring: deque = deque(maxlen=max(1, ring))
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._sampler_ident: Optional[int] = None
        # Samples folded by sample_once, by role, as counted into
        # kft_profile_samples_total{role}; the counter's children a role.
        self.role_samples: Dict[str, int] = {}
        self._metric_children: Dict[str, object] = {}
        self.errors = 0
        # CPU time of the sampler thread itself (time.thread_time around
        # each pass): what always-on sampling costs.
        self.sampler_cpu_seconds = 0.0

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="kft-profiler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop_evt.set()
        t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        self._sampler_ident = threading.get_ident()
        register_thread_role("kft-profiler")
        period = 1.0 / max(self.hz, 0.001)
        while not self._stop_evt.wait(period):
            t0 = time.thread_time()
            try:
                self.sample_once()
            except Exception:
                # Losing one sampling pass is fine; losing the sampler
                # thread is not.  Counted, surfaced via ?list=1.
                self.errors += 1
            finally:
                self.sampler_cpu_seconds += time.thread_time() - t0

    # -- sampling -------------------------------------------------------------

    def _fold(self, frame) -> str:
        parts: List[str] = []
        depth = 0
        truncated = False
        while frame is not None:
            if depth >= self.stack_depth:
                truncated = True
                break
            code = frame.f_code
            fname = code.co_filename
            slash = fname.rfind("/")
            parts.append(f"{fname[slash + 1:]}:{code.co_name}")
            frame = frame.f_back
            depth += 1
        if truncated:
            parts.append(self.TRUNCATED_FRAME)
        parts.reverse()  # root first, the folded-stack convention
        return ";".join(parts)

    def _advance(self, at: float) -> ProfileWindow:
        win = self._current
        if win is None or at >= win.start + self.window_seconds:
            if win is not None:
                win.end = at
                self._ring.append(win)
            self._wid += 1
            win = self._current = ProfileWindow(self._wid, at)
        return win

    def sample_once(self, at: Optional[float] = None) -> int:
        """One sampling pass over every live thread (minus the sampler
        and the caller); returns the number of samples folded in."""
        at = self._now() if at is None else at
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        active = _live_roles(_active_roles)
        static = _live_roles(_static_roles)
        skip = {self._sampler_ident, threading.get_ident()}
        role_counts: Dict[str, int] = {}
        n = 0
        with self._lock:
            win = self._advance(at)
            for ident, frame in frames.items():
                if ident in skip:
                    continue
                role = resolve_role(ident, names.get(ident, ""),
                                    active, static)
                key = (role, self._fold(frame))
                if key not in win.stacks and (
                        len(win.stacks) >= self.max_stacks):
                    key = (role, self.OVERFLOW_FRAME)
                win.stacks[key] = win.stacks.get(key, 0) + 1
                win.samples += 1
                role_counts[role] = role_counts.get(role, 0) + 1
                n += 1
        self._bump_samples(role_counts)
        return n

    def _bump_samples(self, role_counts: Dict[str, int]) -> None:
        if not role_counts:
            return
        from kubeflow_tpu_torch.platform.runtime import metrics

        with self._lock:
            for role, count in role_counts.items():
                self.role_samples[role] = (
                    self.role_samples.get(role, 0) + count)
                child = self._metric_children.get(role)
                if child is None:
                    child = metrics.kft_profile_samples_total.labels(
                        role=role)
                    self._metric_children[role] = child
                child.inc(count)

    def rotate(self, at: Optional[float] = None) -> int:
        """Force-close the current window (tests; rotation is
        time-driven in production).  Returns the new current window id."""
        at = self._now() if at is None else at
        with self._lock:
            win = self._current
            if win is not None:
                win.end = at
                self._ring.append(win)
            self._wid += 1
            self._current = ProfileWindow(self._wid, at)
            return self._wid

    # -- reads ----------------------------------------------------------------

    def current_window_id(self, at: Optional[float] = None) -> int:
        """Id of the window that covers "now", what slow-trace dumps
        reference.  Opens the first window if sampling has not started
        yet."""
        at = self._now() if at is None else at
        with self._lock:
            return self._advance(at).wid

    def _find(self, wid: int) -> Optional[ProfileWindow]:
        win = self._current
        if win is not None and win.wid == wid:
            return win
        for w in self._ring:
            if w.wid == wid:
                return w
        return None

    def windows(self) -> List[dict]:
        """Ring index (oldest closed first, open window last) — the
        ``/debug/profile?list=1`` payload."""
        with self._lock:
            out = [w.index_entry() for w in self._ring]
            if self._current is not None:
                out.append(self._current.index_entry())
            return out

    def folded(self, window: Optional[int] = None) -> Optional[str]:
        """Folded-stack text for one window (default: the open one);
        None when the id has aged out of the ring."""
        with self._lock:
            win = self._current if window is None else self._find(window)
            if win is None:
                return None
            return _folded_lines(win.stacks)

    def diff(self, w1: int, w2: int) -> Optional[str]:
        """Signed per-stack sample deltas ``w2 - w1`` ("what got hot"),
        largest regressions first; None when either window is gone."""
        with self._lock:
            a, b = self._find(w1), self._find(w2)
            if a is None or b is None:
                return None
            deltas: Dict[Tuple[str, str], int] = {}
            for key, count in b.stacks.items():
                deltas[key] = count - a.stacks.get(key, 0)
            for key, count in a.stacks.items():
                if key not in b.stacks:
                    deltas[key] = -count
            return "\n".join(
                f"{role};{stack} {delta:+d}"
                for (role, stack), delta in sorted(
                    deltas.items(), key=lambda kv: (-kv[1], kv[0]))
                if delta)

    def capture(self, seconds: float, hz: Optional[float] = None) -> str:
        """Synchronous on-demand capture (``?seconds=N``): sample at
        ``hz`` for ``seconds`` into a standalone aggregate (never enters
        the ring or the counters) and return the folded text."""
        hz = float(hz or self.hz)
        deadline = time.monotonic() + max(0.0, min(float(seconds), 60.0))
        stacks: Dict[Tuple[str, str], int] = {}
        skip = {self._sampler_ident, threading.get_ident()}
        while True:
            frames = sys._current_frames()
            names = {t.ident: t.name for t in threading.enumerate()}
            active = _live_roles(_active_roles)
            static = _live_roles(_static_roles)
            for ident, frame in frames.items():
                if ident in skip:
                    continue
                role = resolve_role(ident, names.get(ident, ""),
                                    active, static)
                key = (role, self._fold(frame))
                if key not in stacks and len(stacks) >= self.max_stacks:
                    key = (role, self.OVERFLOW_FRAME)
                stacks[key] = stacks.get(key, 0) + 1
            if time.monotonic() >= deadline:
                break
            time.sleep(1.0 / max(hz, 0.001))
        return _folded_lines(stacks)

    def self_seconds(self) -> Dict[str, float]:
        """Per-role self time over the open window (samples / hz)."""
        with self._lock:
            win = self._current
            if win is None:
                return {}
            counts: Dict[str, int] = {}
            for (role, _stack), count in win.stacks.items():
                counts[role] = counts.get(role, 0) + count
        return {role: count / self.hz for role, count in counts.items()}


# -- process-wide debug registration ------------------------------------------
#
# Single-slot: /debug/profile and the Tracer's slow dumps read whatever a
# caller registered; None means the surface 404s and slow dumps skip the
# window reference.

_DEBUG_PROFILER: Optional[Profiler] = None


def register_debug_profiler(p: Optional[Profiler]) -> None:
    global _DEBUG_PROFILER
    _DEBUG_PROFILER = p


def debug_profiler() -> Optional[Profiler]:
    return _DEBUG_PROFILER


def covering_window_id() -> Optional[int]:
    """Window id covering "now" on the registered profiler, or None when
    no profiler runs: the slow-request/slow-step dump reference."""
    p = _DEBUG_PROFILER
    if p is None:
        return None
    try:
        return p.current_window_id()
    except Exception:
        return None
