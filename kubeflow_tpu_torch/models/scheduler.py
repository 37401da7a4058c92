"""Continuous batching across requests for decoder-only serving: a fixed
pool of KV-cache slots and one decode loop over it, in PyTorch.

Counterpart of ``kubeflow_tpu/models/scheduler.py``.  The
lock-serialized path (``models/serve.py``) batches only the rows of one
request, and concurrent users wait behind its lock; here every request's
rows share one running decode loop.

    submit ──► queue ──► admit (prefill, request-batched) ──► slots
                                                               │ decode
               evict (EOS / budget) ◄──────────────────────────┘
                 │
                 └──► freed slot refilled from the queue mid-flight

* **Slots.**  ``model.new_cache(slots, slot_len)`` plus one pad row a
  slot, -1e30 until a row moves in, so a free slot is a fully masked row.
  Every request's prompt + budget must fit ``slot_len``.
* **Admission.**  A queued request prefills exactly as the lock path
  does (``generate_prefill``, K2 once a layer), then each of its rows
  moves into a free slot: its cache rows, first token, position, pad row
  and its own ``torch.Generator``.  Rows that finish at admission (budget
  1, or EOS first) never take a slot; rows that find no free slot wait in
  a pending-insert list and take slots as evictions free them.
* **Decode.**  A quantum is ``quantum`` calls of ``generate.decode_step``
  over the whole pool, with a per-row write slot (``cache_slots``); every
  call launches K5 once a layer at b = slots.  Temperature, top-k and EOS
  ride as per-row tensors, and tokens and done flags stay on the device
  until the harvest reads them.
* **Eviction.**  A row leaves its slot once it has emitted EOS or
  exhausted its budget.  The slot's stale cache bytes need no scrub: the
  next occupant's mask hides them, and masked slots add exact zeros.

Row independence: every op of a pool step is per row (per-row sampling
with the row's own generator, per-row cache writes and masks), and a
row's cache layout in its slot is the one the sequential decode uses, so
a request gives the same tokens pooled as alone.  On the card this holds
bit for bit at a fixed pool width; against the lock path, whose decode
runs at the request's width over a shorter cache, the matmuls and K5 may
sum in another order, so the last bits of the logits can differ.

Pipelined dispatch (``KFT_SERVE_PIPELINE``, default on): the loop
enqueues quantum N+1 from the device-resident carry before it waits for
quantum N's tokens, so the host's bookkeeping overlaps the device.  The
harvest credits tokens against the slot snapshot taken at dispatch, so a
slot refilled meanwhile never inherits its predecessor's tokens; an
admission, whose carry rebuild reads host values, harvests first.

Under a mesh (``mesh=``, the reference's ``scheduler.py:316-369,
495-515``) the pool's batch axis shards over the data axes: a process
holds and computes only its own block of slots (``slots`` must divide
by the data-axis size), every process prefills each admitted request,
and the owner alone moves a row into its slot.  After each quantum the
tokens and done flags are gathered over the data axes, so every
process's bookkeeping sees every slot.  The processes run in lock step
(``parallel/lockstep.py``): rank 0 takes every decision that depends on
the clock or on a request (which request is admitted next, whether a
dispatched quantum is back, stop) and sends it before the device work
it steers; a follower (``follow()``) applies rank 0's decisions to its
own copy and takes none.  Under lock step an error in device work ends
the world instead of failing one request.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, List, Optional

import torch

from kubeflow_tpu_torch.models.generate import (
    NEG_INF,
    DecodeState,
    SamplingRows,
    decode_step,
    generate_prefill,
    row_generators,
)
from kubeflow_tpu_torch.parallel.sharding import data_coordinates, gather_data
from kubeflow_tpu_torch.platform import config

# Request priority classes (the X-KFT-Priority wire vocabulary), lowest
# value admitted first, FIFO within a class; decode slots already held are
# never preempted.
PRIORITY_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}
DEFAULT_PRIORITY = PRIORITY_CLASSES["standard"]


_REQUEST_IDS = itertools.count()


class DeadlineExceeded(RuntimeError):
    """The request's deadline (X-KFT-Deadline-Seconds) ran out while it
    was still queued; the serving app maps this to a 504."""


def pool_steps(model, state: DecodeState, rows: SamplingRows,
               write: torch.Tensor, quantum: int):
    """``quantum`` decode steps over the whole pool.  ``state`` (the pool
    cache, tokens, positions, done flags, pad rows and the slots'
    generators) advances in place; ``write`` [slots] is each row's next
    cache slot.  Returns ``(write, toks [quantum, slots], dones [quantum,
    slots])``, all on the device: nothing here reads a tensor on the
    host."""
    last = state.cache.length - 1
    toks, dones = [], []
    for _ in range(quantum):
        # Finished rows step on until the host evicts them; their
        # (discarded) writes are clamped into their own slot.
        toks.append(decode_step(model, state, rows,
                                cache_slots=write.clamp_max(last)))
        dones.append(state.done)
        write = write + 1
    return write, torch.stack(toks), torch.stack(dones)


class PendingRequest:
    """Submit-side handle: the request thread waits on the lifecycle
    events (admitted, first token, done) that the scheduler thread sets;
    ``result()`` returns the rows or raises the scheduler-side error."""

    def __init__(self, rows, *, max_new_tokens, temperature, top_k,
                 eos_token, seed, priority=DEFAULT_PRIORITY, deadline=None):
        self.rows = rows
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_token = eos_token
        self.seed = seed
        self.priority = priority    # admission class, lower admits first
        self.deadline = deadline    # absolute time.monotonic() cutoff
        self.tokens = None          # optional right-padded [b, L] prompt
        self.prompt_mask = None     # optional [b, L] validity mask
        self.outputs: List[Optional[list]] = [None] * len(rows)
        self.remaining = len(rows)
        self.error: Optional[BaseException] = None
        self.admitted = threading.Event()
        self.first_token = threading.Event()
        self.done = threading.Event()
        self.t_admitted: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.id = next(_REQUEST_IDS)

    def spec(self) -> dict:
        """What a lock-step follower needs to run this request as rank 0
        does (``from_spec``)."""
        return {"id": self.id, "rows": self.rows,
                "max_new_tokens": self.max_new_tokens,
                "temperature": self.temperature, "top_k": self.top_k,
                "eos_token": self.eos_token, "seed": self.seed,
                "priority": self.priority}

    @classmethod
    def from_spec(cls, spec: dict) -> "PendingRequest":
        spec = dict(spec)
        rid = spec.pop("id")
        req = cls(spec.pop("rows"), **spec)
        req.id = rid
        return req

    def _fail(self, exc: BaseException):
        self.error = exc
        self.admitted.set()
        self.first_token.set()
        self.done.set()

    def wait_admitted(self):
        self.admitted.wait()
        if self.error is not None:
            raise self.error

    def wait_first_token(self):
        self.first_token.wait()
        if self.error is not None:
            raise self.error

    def result(self) -> List[list]:
        self.done.wait()
        if self.error is not None:
            raise self.error
        return list(self.outputs)


class _Slot:
    """Host-side bookkeeping for one pool row."""

    __slots__ = ("req", "row", "first", "token", "pos", "write", "done",
                 "budget", "collected", "temp", "top_k", "eos", "has_eos",
                 "_cache", "_generator", "_pad_row")

    def __init__(self, req, row, *, token, pos, write, done, budget):
        self.req = req
        self.row = row
        self.first = token            # the prefill-sampled first token
        self.token = token            # model input for the next step
        self.pos = pos
        self.write = write
        self.done = done
        self.budget = budget          # decode tokens still owed (n - 1)
        self.collected: List[int] = []
        self.temp = req.temperature
        self.top_k = req.top_k or 0
        self.eos = req.eos_token if req.eos_token is not None else 0
        self.has_eos = req.eos_token is not None


class _Inflight:
    """One dispatched, unharvested quantum: its tokens and done flags on
    their way to the host (``event`` marks the copy's end on the card),
    and the slots that were live at dispatch.  The harvest collects only
    for slots whose occupant is still the one of the snapshot."""

    __slots__ = ("toks", "dones", "event", "snapshot", "quantum")

    def __init__(self, toks, dones, event, snapshot, quantum):
        self.toks = toks
        self.dones = dones
        self.event = event
        self.snapshot = snapshot
        self.quantum = quantum


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start ``t``'s copy to the host without waiting for it (pinned
    memory, on the current stream)."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class DecodeScheduler:
    """The continuous-batching engine: one background thread owns the
    device work (prefills at admission, the pool's decode quanta);
    request threads ``submit()`` and block on the returned
    ``PendingRequest``.

    Knobs (constructor argument, else the environment):
      slots     KFT_SERVE_SLOTS            pool width (default 8)
      slot_len  KFT_SERVE_SLOT_LEN         cache positions a slot
                                           (default the model's
                                           max_seq_len, never above it)
      quantum   KFT_SERVE_DECODE_QUANTUM   decode steps a dispatch and
                                           admission check (default 8)
      pipeline  KFT_SERVE_PIPELINE         pipelined dispatch (default on)

    A crash in the loop fails every outstanding request with the error
    and marks the scheduler dead (``alive`` False); the service then
    serves on the lock path instead of hanging its clients."""

    def __init__(self, model, *, slots: Optional[int] = None,
                 slot_len: Optional[int] = None,
                 quantum: Optional[int] = None,
                 pipeline: Optional[bool] = None,
                 telemetry: Optional[Callable[[], object]] = None,
                 mesh=None, lockstep=None):
        self.model = model
        # The mesh the model is sharded over, and the lock-step channel
        # of its processes (None on one process).
        self.mesh = mesh
        self.lockstep = lockstep
        self.slots = slots or config.env_int("KFT_SERVE_SLOTS", 8)
        self.slot_len = slot_len or config.env_int(
            "KFT_SERVE_SLOT_LEN", 0) or model.cfg.max_seq_len
        self.quantum = quantum or config.env_int(
            "KFT_SERVE_DECODE_QUANTUM", 8)
        if self.slots < 1 or self.quantum < 1 or self.slot_len < 2:
            raise ValueError(
                f"slots {self.slots} and quantum {self.quantum} must be >= "
                f"1 and slot_len {self.slot_len} >= 2")
        if self.slot_len > model.cfg.max_seq_len:
            raise ValueError(
                f"slot_len {self.slot_len} exceeds the model's "
                f"max_seq_len {model.cfg.max_seq_len}")
        self.pipeline = pipeline if pipeline is not None else \
            config.env_bool("KFT_SERVE_PIPELINE", True)
        # The slots this process holds and computes, [lo, hi).
        self._lo, self._hi, self._row_shards = self._local_rows()
        # Zero-arg callable, so a service can re-attach telemetry (every
        # create_app builds a fresh registry).
        self._telemetry = telemetry or (lambda: None)

        self._cond = threading.Condition()
        self._queue: List[PendingRequest] = []
        self._pending_rows: List[_Slot] = []  # prefilled, waiting for slots
        self._slot_state: List[Optional[_Slot]] = [None] * self.slots
        self._stop_flag = False
        self._dead: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._admitted_total = 0
        self._evicted_total = 0
        self._steps_total = 0
        self._prefills_total = 0

        # Device state, touched only by the loop thread once started.
        self._pool = None          # KVCache [slots, slot_len, kv_h, d]
        self._pad_rows = None      # [slots, slot_len] f32
        self._gens = None          # a generator per slot
        self._spare = None         # the free slots' generator
        self._carry = None         # (DecodeState, SamplingRows, write)
        self._inflight: Optional[_Inflight] = None
        self._blocked_s = 0.0
        self._cycle_s = 0.0
        self._t_cycle_mark: Optional[float] = None

    def _local_rows(self) -> tuple:
        """``(lo, hi, shards)``: this process's block of the slots, of
        ``shards`` equal blocks over the mesh's data axes."""
        index, count = (data_coordinates(self.mesh)
                        if self.mesh is not None else (0, 1))
        if self.slots % count:
            raise ValueError(
                f"slots {self.slots} must divide over the mesh's data axes "
                f"({count} processes)")
        n = self.slots // count
        return index * n, (index + 1) * n, count

    def knobs(self) -> dict:
        """The constructor's sizing knobs as resolved here (a lock-step
        follower builds its copy from rank 0's)."""
        return {"slots": self.slots, "slot_len": self.slot_len,
                "quantum": self.quantum, "pipeline": self.pipeline}

    # -- public surface ---------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._dead is None and not self._stop_flag

    def submit(self, rows: List[List[int]], *, max_new_tokens: int,
               temperature: float = 0.0, top_k: Optional[int] = None,
               eos_token: Optional[int] = None, seed: int = 0,
               tokens=None, prompt_mask=None,
               priority: int = DEFAULT_PRIORITY,
               deadline: Optional[float] = None) -> PendingRequest:
        """Queue one request (a list of prompt token rows).  Raises
        ValueError at once when prompt + budget cannot fit a slot.
        ``tokens``/``prompt_mask`` may carry the right-padded tensors the
        serving layer already made; without them the rows are padded
        here."""
        longest = max(len(r) for r in rows)
        if longest + max_new_tokens > self.slot_len:
            raise ValueError(
                f"prompt_len ({longest}) + max_new_tokens "
                f"({max_new_tokens}) = {longest + max_new_tokens} exceeds "
                f"the scheduler slot length {self.slot_len}")
        req = PendingRequest(
            rows, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_token=eos_token, seed=seed,
            priority=priority, deadline=deadline)
        req.tokens = tokens
        req.prompt_mask = prompt_mask
        tel = self._telemetry()
        with self._cond:
            # Under the lock: a loop crash concurrent with this submit
            # either fails the request here or finds it in the queue.
            if self._dead is not None:
                raise RuntimeError("decode scheduler is dead") from self._dead
            if self._stop_flag:
                raise RuntimeError("decode scheduler is stopped")
            self._queue.append(req)
            if tel is not None:
                tel.queue_depth.inc(len(rows))
            self._cond.notify()
        self.start()
        return req

    def start(self):
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return
            if self._dead is not None or self._stop_flag:
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="kft-decode-scheduler")
            self._thread.start()

    def stop(self):
        """Stop the loop; outstanding requests fail with RuntimeError."""
        with self._cond:
            self._stop_flag = True
            self._cond.notify()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def stats(self) -> dict:
        with self._cond:
            queued = sum(len(r.rows) for r in self._queue) + len(
                self._pending_rows)
        return {
            "queued_rows": queued,
            "active_rows": sum(s is not None for s in self._slot_state),
            "admitted_total": self._admitted_total,
            "evicted_total": self._evicted_total,
            "prefills_total": self._prefills_total,
            "steps_total": self._steps_total,
            "slots": self.slots,
            "slot_len": self.slot_len,
            "quantum": self.quantum,
            "pipeline": self.pipeline,
            "alive": self.alive,
            "dispatch_blocked_s": round(self._blocked_s, 6),
            "dispatch_cycle_s": round(self._cycle_s, 6),
            "dispatch_overlap_ratio": round(
                1.0 - self._blocked_s / self._cycle_s, 6)
            if self._cycle_s > 0 else 0.0,
        }

    # -- loop thread ------------------------------------------------------

    def follow(self):
        """A lock-step follower: run the loop in this thread on rank 0's
        decisions until rank 0 stops it; an error (here or rank 0's
        abort) is raised."""
        self._loop()
        if self._dead is not None:
            raise self._dead

    def _decide(self, fn):
        """``fn()``; under lock step rank 0's value on every process."""
        return fn() if self.lockstep is None else self.lockstep.decide(fn)

    def _wait_for_work(self) -> bool:
        """Sleep until there is work or a stop; True to stop."""
        with self._cond:
            while (not self._stop_flag and not self._queue
                   and not self._pending_rows
                   and self._inflight is None
                   and all(s is None for s in self._slot_state)):
                self._cond.wait()
            return self._stop_flag

    def _loop(self):
        try:
            with torch.inference_mode():
                self._ensure_pool()
                while True:
                    if self._decide(self._wait_for_work):
                        break
                    self._admit()
                    if any(s is not None for s in self._slot_state):
                        self._run_quantum()
                    else:
                        # Every slot drained at the last harvest while one
                        # more quantum was in flight: drain it (its slots
                        # are all stale) before sleeping.
                        self._harvest()
        except BaseException as exc:  # noqa: BLE001 — fail every waiter
            self._dead = exc
            if self.lockstep is not None:
                self.lockstep.abort(exc)
            self._fail_outstanding(exc)
            return
        self._fail_outstanding(RuntimeError("scheduler stopped"))

    def _ensure_pool(self):
        if self._pool is not None:
            return
        dev = self.model.device
        local = self._hi - self._lo
        self._pool = self.model.new_cache(local, self.slot_len)
        self._pad_rows = torch.full((local, self.slot_len), NEG_INF,
                                    dtype=torch.float32, device=dev)
        self._spare = torch.Generator(device=dev).manual_seed(0)
        self._gens = [self._spare] * local

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slot_state) if s is None]

    def _next_queued(self, *, pop: bool) -> Optional[PendingRequest]:
        """The request to admit next (``_pick_queued``); under lock step
        rank 0's pick.  A follower has no queue: rank 0 owns it, with its
        deadlines, so a follower builds each pick anew from rank 0's spec
        and keeps none that does not start."""
        if self.lockstep is None:
            return self._pick_queued(pop=pop)
        if self.lockstep.leader:
            req = self._pick_queued(pop=pop)
            self.lockstep.decide(lambda: None if req is None else req.spec())
            return req
        spec = self.lockstep.decide()
        return None if spec is None else PendingRequest.from_spec(spec)

    def _pick_queued(self, *, pop: bool) -> Optional[PendingRequest]:
        """Admission-order selection under the queue lock: first fail the
        queued requests whose deadline has passed (they never reach
        prefill), then pick the lowest priority class, FIFO within it.
        ``pop`` removes the pick."""
        now = time.monotonic()
        with self._cond:
            expired = [r for r in self._queue
                       if r.deadline is not None and now >= r.deadline]
            if expired:
                self._queue = [r for r in self._queue if r not in expired]
            req = None
            if self._queue:
                i = min(range(len(self._queue)),
                        key=lambda j: self._queue[j].priority)
                req = self._queue.pop(i) if pop else self._queue[i]
        tel = self._telemetry()
        for dead in expired:
            dead._fail(DeadlineExceeded(
                "request deadline expired while queued "
                f"({now - dead.deadline:.3f}s past cutoff)"))
            if tel is not None:
                tel.queue_depth.dec(len(dead.rows))
        return req

    def _admit(self):
        """Fill free slots: first from prefilled pending rows, then by
        prefilling queued requests.  Rows live in ``_pending_rows`` (or
        the queue) whenever a device call can raise, so
        ``_fail_outstanding`` always reaches their requests."""
        while True:
            free = self._free_slots()
            while free and self._pending_rows:
                self._place(self._pending_rows[0], free.pop(0))
                self._pending_rows.pop(0)
            if not free or self._pending_rows:
                return
            req = self._next_queued(pop=True)
            if req is None:
                return
            try:
                self._pending_rows.extend(self._prefill(req))
            except BaseException as exc:  # noqa: BLE001 — per request
                if self.lockstep is not None:
                    raise       # the processes may have diverged
                req._fail(exc)
                tel = self._telemetry()
                if tel is not None:
                    tel.queue_depth.dec(len(req.rows))

    def _prefill(self, req: PendingRequest) -> List[_Slot]:
        """The lock path's prompt pass (``generate_prefill``, the same
        shapes and the same per-row generators), then one slot state a
        row.  Rows already complete (budget 1, or EOS first) finish here
        without a slot."""
        dev = self.model.device
        rows = req.rows
        if req.tokens is not None:
            prompt, mask = req.tokens, req.prompt_mask
        else:
            longest = max(len(r) for r in rows)
            prompt = torch.tensor([r + [0] * (longest - len(r))
                                   for r in rows], dtype=torch.long,
                                  device=dev)
            mask = torch.tensor([[True] * len(r) + [False] * (longest - len(r))
                                 for r in rows], dtype=torch.bool, device=dev)
        n = req.max_new_tokens
        req.t_admitted = time.perf_counter()
        req.admitted.set()
        gens = row_generators(req.seed, len(rows), dev)
        first, state = generate_prefill(
            self.model, prompt, prompt_mask=mask, max_new_tokens=n,
            temperature=req.temperature, top_k=req.top_k,
            eos_token=req.eos_token, generators=gens)
        self._prefills_total += 1
        first_h, pos_h, done_h = torch.stack(
            [first, state.pos, state.done.long()]).tolist()
        req.t_first = time.perf_counter()
        req.first_token.set()
        # Slot pad rows: the request's prompt padding, zeros past its
        # cache (the per-row causal mask hides them until written).
        cache_len = state.pad_bias.shape[-1]
        pads = torch.zeros(len(rows), self.slot_len, dtype=torch.float32,
                           device=dev)
        pads[:, :cache_len] = state.pad_bias
        tel = self._telemetry()
        out = []
        eos = req.eos_token
        for i in range(len(rows)):
            if n == 1 or done_h[i]:
                # Complete at admission: counted admitted and evicted at
                # once, so admitted == evicted + active holds throughout;
                # the lock path right-pads with EOS the same way.
                self._admitted_total += 1
                self._evicted_total += 1
                if tel is not None:
                    tel.queue_depth.dec(1)
                    tel.scheduler_admitted.inc()
                    tel.scheduler_evicted.inc()
                self._complete_row(req, i, [first_h[i]] + [eos] * (n - 1))
                continue
            slot = _Slot(req, i, token=first_h[i], pos=pos_h[i],
                         write=prompt.shape[1], done=False, budget=n - 1)
            slot._cache = state.cache        # sliced at placement
            slot._generator = gens[i]
            slot._pad_row = pads[i]
            out.append(slot)
        return out

    def _place(self, slot: _Slot, idx: int):
        """Move a prefilled row into pool slot ``idx``: its cache rows,
        layer by layer, its pad row and its generator (on the process
        that holds the slot).  Admission is counted here: a row waiting
        for a slot still reads as queued."""
        if self._lo <= idx < self._hi:
            j = idx - self._lo
            src = slot._cache
            length = src.length
            for layer in range(len(src.k)):
                self._pool.k[layer][j, :length].copy_(src.k[layer][slot.row])
                self._pool.v[layer][j, :length].copy_(src.v[layer][slot.row])
            self._pad_rows[j].copy_(slot._pad_row)
            self._gens[j] = slot._generator
        self._admitted_total += 1
        tel = self._telemetry()
        if tel is not None:
            tel.queue_depth.dec(1)
            tel.scheduler_admitted.inc()
            tel.slots_active.set(
                1 + sum(s is not None for s in self._slot_state))
        # Drop the request cache, so it frees once its last row is placed.
        del slot._cache, slot._generator, slot._pad_row
        self._slot_state[idx] = slot
        # The device carry no longer reflects the pool: rebuild it from
        # the slot bookkeeping before the next quantum.
        self._carry = None

    def _run_quantum(self):
        """One decode quantum, pipelined: enqueue quantum N+1 from the
        device-resident carry first, then harvest quantum N.  At most
        one quantum is unharvested.  ``pipeline=False`` harvests its own
        dispatch at once (the synchronous loop, token-identical)."""
        if self._pre_dispatch_sync():
            return
        prev = self._inflight
        if prev is not None and self._inflight_ready(prev):
            # Quantum N's tokens are already on the host: harvesting first
            # costs no wait and gets its evictions (and the admissions
            # they allow) into quantum N+1.
            self._harvest_handle(prev)
            self._inflight = prev = None
            self._admit()
            if self._pre_dispatch_sync():
                return
        self._inflight = self._dispatch_quantum()
        if prev is not None:
            self._harvest_handle(prev)
        if not self.pipeline:
            self._harvest()

    def _inflight_ready(self, h: _Inflight) -> bool:
        """Whether a dispatched quantum's results are on the host already
        (a query, never a wait; under lock step rank 0's answer)."""
        return self._decide(lambda: h.event is None or h.event.query())

    def _pre_dispatch_sync(self) -> bool:
        """A cleared carry means an admission changed the pool, and its
        rebuild reads host values that only the pending harvest brings:
        harvest first.  True when nothing is left to dispatch."""
        if self._carry is None:
            self._harvest()
        return not any(s is not None for s in self._slot_state)

    def _dispatch_quantum(self) -> _Inflight:
        """Enqueue one quantum over the pool and return its unharvested
        handle.  The carry (tokens, positions, write slots, done flags
        and the per-row sampling tensors) stays on the device between
        quanta; only an admission rebuilds it from the host's
        bookkeeping.  An eviction leaves it: the freed slot steps on with
        its writes clamped into its own masked row and its tokens
        discarded, until the next occupant overwrites what matters.
        Under a mesh the carry holds this process's slots, and the
        quantum's tokens and done flags are gathered over the data axes."""
        state = self._slot_state[self._lo:self._hi]
        if self._carry is None:
            dev = self.model.device
            t = lambda vals, dtype: torch.tensor(vals, dtype=dtype,
                                                 device=dev)
            temps = [s.temp if s else 0.0 for s in state]
            dstate = DecodeState(
                cache=self._pool,
                token=t([s.token if s else 0 for s in state], torch.long),
                pos=t([s.pos if s else 0 for s in state], torch.long),
                done=t([s.done if s else True for s in state], torch.bool),
                pad_bias=self._pad_rows, generators=self._gens, budget=0)
            rows = SamplingRows(
                temps=t(temps, torch.float32),
                top_ks=t([s.top_k if s else 0 for s in state], torch.long),
                eos_ids=t([s.eos if s else 0 for s in state], torch.long),
                has_eos=t([s.has_eos if s else False for s in state],
                          torch.bool),
                sampled=any(x != 0.0 for x in temps))
            write = t([s.write if s else 0 for s in state], torch.long)
            self._carry = (dstate, rows, write)
        dstate, rows, write = self._carry
        write, toks, dones = self._pool_steps(dstate, rows, write)
        self._carry = (dstate, rows, write)
        if self._row_shards > 1:
            both = gather_data(torch.stack([toks, dones.long()]), self.mesh,
                               dim=2)
            toks, dones = both[0], both[1].bool()
        toks_h, dones_h = _to_host(toks), _to_host(dones)
        event = None
        if toks.is_cuda:
            event = torch.cuda.Event()
            event.record()
        if self._t_cycle_mark is None:
            self._t_cycle_mark = time.perf_counter()
        return _Inflight(toks_h, dones_h, event, list(self._slot_state),
                         self.quantum)

    def _pool_steps(self, dstate, rows, write):
        return pool_steps(self.model, dstate, rows, write, self.quantum)

    def _harvest(self):
        # ``_inflight`` clears once the harvest is booked, so a reader that
        # sees it None and no live row reads the final counts in stats().
        if self._inflight is not None:
            self._harvest_handle(self._inflight)
            self._inflight = None

    def _harvest_handle(self, h: _Inflight):
        """Wait for one quantum's tokens, then the host bookkeeping: token
        collection, EOS/budget eviction, overlap accounting.  Collection
        goes by the dispatch-time snapshot."""
        t0 = time.perf_counter()
        if h.event is not None:
            h.event.synchronize()
        toks_h, dones_h = h.toks.tolist(), h.dones.tolist()
        t1 = time.perf_counter()
        # Overlap: the share of each dispatch-to-harvest cycle the host
        # was not blocked waiting for the device.
        self._blocked_s += t1 - t0
        self._cycle_s += t1 - self._t_cycle_mark
        self._t_cycle_mark = t1
        self._steps_total += h.quantum
        tel = self._telemetry()
        if tel is not None:
            active = sum(s is not None for s in h.snapshot)
            tel.batch_fill_ratio.observe(active / self.slots)
            if self._cycle_s > 0:
                tel.dispatch_overlap.set(
                    1.0 - self._blocked_s / self._cycle_s)
        for i, slot in enumerate(h.snapshot):
            if slot is None or self._slot_state[i] is not slot:
                continue
            for t in range(h.quantum):
                if len(slot.collected) >= slot.budget:
                    break
                slot.collected.append(toks_h[t][i])
                slot.done = dones_h[t][i]
            slot.token = toks_h[h.quantum - 1][i]
            slot.pos += h.quantum
            slot.write += h.quantum
            if slot.done or len(slot.collected) >= slot.budget:
                self._evict(i)

    def _evict(self, idx: int):
        slot = self._slot_state[idx]
        self._slot_state[idx] = None
        if self._lo <= idx < self._hi:
            self._gens[idx - self._lo] = self._spare
        # First token + decode tokens, EOS-padded to the budget: the lock
        # path's right-padding after EOS.
        fill = slot.req.eos_token
        out = slot.collected + [fill] * (slot.budget - len(slot.collected))
        self._complete_row(slot.req, slot.row, [slot.first] + out)
        self._evicted_total += 1
        tel = self._telemetry()
        if tel is not None:
            tel.scheduler_evicted.inc()
            tel.slots_active.set(sum(s is not None for s in self._slot_state))

    def _complete_row(self, req: PendingRequest, row: int, tokens: list):
        req.outputs[row] = tokens
        req.remaining -= 1
        if req.remaining == 0:
            req.t_done = time.perf_counter()
            req.done.set()

    def _fail_outstanding(self, exc: BaseException):
        # Drop the unharvested quantum: its slots fail below, and a dead
        # scheduler must not wait on results nobody reads.
        self._inflight = None
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            pending = list(self._pending_rows)
            self._pending_rows.clear()
        tel = self._telemetry()
        for req in queued:
            if tel is not None:
                tel.queue_depth.dec(len(req.rows))
            req._fail(exc)
        # Pending rows were never admitted (admission counts at
        # placement), so they only drain the queue gauge; slot rows were,
        # so they count as evicted and admitted == evicted + active holds
        # after a crash.  A row that crashed between its placement and its
        # pop from the pending list is in both: counted once, as placed.
        placed = {id(s) for s in self._slot_state if s}
        pending = [s for s in pending if id(s) not in placed]
        if tel is not None and pending:
            tel.queue_depth.dec(len(pending))
        seen = set()
        for slot in pending + [s for s in self._slot_state if s]:
            if id(slot.req) not in seen:
                seen.add(id(slot.req))
                slot.req._fail(exc)
        in_flight = sum(s is not None for s in self._slot_state)
        self._evicted_total += in_flight
        self._slot_state = [None] * self.slots
        if tel is not None:
            if in_flight:
                tel.scheduler_evicted.inc(in_flight)
            tel.slots_active.set(0)
