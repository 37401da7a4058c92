"""FlightPool: bounded fan-out for independent I/O inside one reconcile.
The port's copy of ``kubeflow_tpu/platform/runtime/flight.py``.

A notebook reconcile writes ~5 independent secondaries (slice
StatefulSets, Service, headless Service, PDB, VirtualService); doing them
one blocking HTTP round trip at a time makes the wall time of the hot
path 5x the slowest write for no reason.  client-go reconcilers fan such
writes out over goroutines; the Python analogue is a small shared thread
pool — SHARED and BOUNDED, so ``workers x secondaries`` parallelism can't
grow an unbounded thread count (or overwhelm the apiserver) as worker
counts rise.

Semantics (the reference's, held by tests/ctrlplane/test_flight.py):

* ``run(calls)`` executes the zero-arg callables concurrently, waits for
  ALL of them, and returns their results in submission order — status
  aggregation always sees every result, never a partial fan-out.
* Errors propagate per-slot: with ``return_exceptions=True`` each slot
  holds its result OR its exception; by default the first (by submission
  order) exception re-raises after every slot has settled, so a failed
  sibling never cancels — or hides — the others' writes.
* Nested fan-out runs inline: a callable that itself calls ``run()``
  (directly or through shared helpers) executes its calls on the current
  thread instead of queueing behind its own parent — a saturated pool can
  therefore never deadlock on itself.
* ``size <= 1`` (or a single call) short-circuits to inline execution —
  unit tests that want strict sequential determinism set
  ``CONTROLLER_FLIGHT_POOL_SIZE=1``.

Threads are lazy daemon workers created on demand up to ``size`` and kept
for the process lifetime (reconciles fan out continuously; pool churn
would dominate the win).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Sequence

from kubeflow_tpu_torch.platform import config

# Shared-pool size: bounds TOTAL concurrent secondary flights across every
# controller in the process (workers x per-reconcile fan-out).  The REST
# client's connection pool (K8S_CLIENT_POOL_SIZE) should be sized >= this
# + worker count or flights queue on sockets instead of the semaphore.
DEFAULT_POOL_SIZE = 16

# Marks flight worker threads so nested run() calls execute inline.
_local = threading.local()


class FlightPool:
    """Bounded shared executor for intra-reconcile fan-out."""

    def __init__(self, size: Optional[int] = None, *, name: str = "flight"):
        if size is None:
            size = config.env_int("CONTROLLER_FLIGHT_POOL_SIZE",
                                  DEFAULT_POOL_SIZE)
        self.size = max(1, int(size))
        self.name = name
        self._work: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._idle = 0  # workers blocked on the queue right now

    # -- workers -------------------------------------------------------------

    def _spawn_for(self, n_calls: int) -> None:
        """Ensure enough workers exist for the new batch, up to size."""
        with self._lock:
            want = min(self.size, len(self._threads) - self._idle + n_calls)
            while len(self._threads) < want:
                t = threading.Thread(
                    target=self._worker,
                    name=f"{self.name}-{len(self._threads)}", daemon=True)
                self._threads.append(t)
                t.start()

    def _worker(self) -> None:
        _local.in_flight = True
        # Claim a stable profile role at birth: between carries this
        # thread samples under the pool's name instead of defeating
        # profile grouping as Thread-N; a slot carrying a submitted
        # trace overrides it via the Tracer adopt seam.
        from kubeflow_tpu_torch.telemetry import profiler
        profiler.register_thread_role(self.name)
        while True:
            with self._lock:
                self._idle += 1
            item = self._work.get()
            with self._lock:
                self._idle -= 1
            fn, slot, results, errors, cond, remaining = item
            try:
                results[slot] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised per-slot
                errors[slot] = e
            finally:
                with cond:
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        cond.notify_all()

    # -- API -----------------------------------------------------------------

    def run(self, calls: Sequence[Callable[[], Any]], *,
            return_exceptions: bool = False) -> List[Any]:
        """Execute ``calls`` concurrently; block until ALL settle; return
        results in submission order.  See module docstring for the error
        and nesting contracts."""
        calls = list(calls)
        n = len(calls)
        if n == 0:
            return []
        if n == 1 or self.size <= 1 or getattr(_local, "in_flight", False):
            return self._run_inline(calls, return_exceptions)
        from kubeflow_tpu_torch.platform.runtime import metrics, sharding, trace
        from kubeflow_tpu_torch.telemetry import causal

        # Carry the submitting reconcile's thread-locals onto the pool
        # threads (thread-locals do not cross threads by themselves), all
        # three on the same carry: the fence context, so a fanned-out
        # secondary write fences on the same key as its reconcile's
        # inline writes; the causal context, so a child created from a
        # flight slot inherits the reconcile's journey
        # (apply.stamp_child); and the trace, so a span opened in a slot
        # lands in the reconcile's trace.
        fence_req = sharding.current_request()
        cctx = causal.current()
        submit_trace = trace.current()
        # Marks recorded inside a slot land on the POOL thread's local;
        # collect them so the submitting reconcile still reads as acting.
        slot_marked = [False]
        if fence_req is not None or cctx is not None \
                or submit_trace is not None:
            def _carry(fn, _req=fence_req, _ctx=cctx, _tr=submit_trace):
                def wrapped():
                    sharding.set_current_request(_req)
                    causal.set_current(_ctx)
                    trace.adopt(_tr)
                    try:
                        return fn()
                    finally:
                        if causal.consume_mark():
                            slot_marked[0] = True
                        sharding.set_current_request(None)
                        causal.set_current(None)
                        trace.adopt(None)
                return wrapped

            calls = [_carry(fn) for fn in calls]

        results: List[Any] = [None] * n
        errors: List[Optional[BaseException]] = [None] * n
        cond = threading.Condition()
        remaining = [n]
        self._spawn_for(n)
        metrics.flight_pool_flights_total.labels(pool=self.name).inc(n)
        for i, fn in enumerate(calls):
            self._work.put((fn, i, results, errors, cond, remaining))
        with cond:
            while remaining[0]:
                cond.wait()
        if slot_marked[0]:
            causal.mark_thread()
        return self._settle(results, errors, return_exceptions)

    @staticmethod
    def _run_inline(calls, return_exceptions: bool) -> List[Any]:
        # Same settle contract as the pooled path: every call runs even
        # after an earlier one raised (a failed sibling must not hide the
        # others' writes at size=1 either), then the first error re-raises.
        results: List[Any] = [None] * len(calls)
        errors: List[Optional[BaseException]] = [None] * len(calls)
        for i, fn in enumerate(calls):
            try:
                results[i] = fn()
            except BaseException as e:  # noqa: BLE001
                errors[i] = e
        return FlightPool._settle(results, errors, return_exceptions)

    @staticmethod
    def _settle(results, errors, return_exceptions: bool) -> List[Any]:
        if return_exceptions:
            return [e if e is not None else r
                    for r, e in zip(results, errors)]
        for e in errors:
            if e is not None:
                raise e
        return results


_shared: Optional[FlightPool] = None
_shared_lock = threading.Lock()


def shared_pool() -> FlightPool:
    """The process-wide pool every controller's fan-out shares (bounding
    worker x flight parallelism globally).  The size is re-resolved from
    ``CONTROLLER_FLIGHT_POOL_SIZE`` on every call: a changed env yields a
    fresh singleton (the superseded pool's idle daemon threads are
    abandoned — config changes are a test/startup event, not a hot path),
    so callers constructed AFTER an env change — the monkeypatch-then-
    construct test recipe — actually get the size they asked for.
    Callers capture the pool at construction; a pool already handed out
    keeps its size."""
    global _shared
    size = max(1, config.env_int("CONTROLLER_FLIGHT_POOL_SIZE",
                                 DEFAULT_POOL_SIZE))
    with _shared_lock:
        if _shared is None or _shared.size != size:
            _shared = FlightPool(size, name="controller")
        return _shared
