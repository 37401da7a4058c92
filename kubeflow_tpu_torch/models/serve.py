"""Generation server: serve a decoder or an encoder-decoder of the model
zoo over HTTP, in PyTorch on the card.

    python -m kubeflow_tpu_torch.models.serve --model llama3_8b --port 8080

Counterpart of ``kubeflow_tpu/models/serve.py``.  An instrumented
service (the app of ``create_app``) routes every request through the
paged engine, ``PagedDecodeScheduler`` (``models/paged.py``: page
tables, the prefix cache, chunked prefill and, with ``--draft-model``,
speculative decoding), unless ``KFT_SERVE_PAGED=0`` pins the fixed-slot
``DecodeScheduler`` (``models/scheduler.py``; the pin is recorded in
``/debug/serve`` and counted in ``serve_paged_fallback_total``), or
``KFT_SERVE_SCHEDULER=0`` (or ``use_scheduler=False``) the
lock-serialized path; library use of a bare ``GenerationService`` takes
the lock path.  A scheduler whose loop crashed fails over to the lock
path.  An encoder-decoder (``--model t5_large``) is served by
``Seq2SeqGenerationService``, always on the lock path.  The server is
the standard library's ``ThreadingHTTPServer`` under the torch-free
app of ``platform/web/serve_app.py``, which this module re-exports
(``App``, ``Request``, ``json_response``, ...); weights are random,
drawn from ``--seed`` on the device, unless ``--checkpoint-dir`` names a
trainer's checkpoints (``train/checkpoint.py``), whose latest parameters
are restored in the serving dtype.  ``--quantize int8`` keeps the
matmul and embedding weights as int8 with per-channel scales
(``models/quantize.py``), dequantized at use; ``--n-layers`` cuts a
decoder's depth at full width (``mixtral_8x7b``'s 32 layers do not fit
one 80 GB card).

``--mesh tp=2`` (or ``tp=2,fsdp=2``, ``ep=2``, ``auto``) serves the model
sharded over a mesh of the world's processes, one a GPU, each holding
its shards by the family's partition rules (``parallel/sharding.py``):

    torchrun --nproc-per-node 2 -m kubeflow_tpu_torch.models.serve \
        --mesh tp=2 --model llama3_8b

Every process runs the same device work in lock step
(``parallel/lockstep.py``): global rank 0 serves HTTP and takes every
decision that depends on the clock or a request, the others follow it
and bind no port.  Every family computes what the rules split over
``tp`` as its shards (heads, MLP and expert columns, the
vocabulary-parallel embedding and head, whose logits are gathered before
sampling), a Mixtral its experts as their ``ep`` shards; only ``fsdp``
splits are gathered at their use.  The fixed-slot pool
shards its slots over the data axes, the paged engine its pool
positions.  A draft model under a mesh is inert: the fixed-slot pool
serves (``spec-decode-mesh``).  ``--device cpu`` serves the same over
gloo.

Endpoints:
  GET  /healthz             liveness
  GET  /readyz              readiness: runs (and caches) a one-token warm
                            generate; 200 only after the model produced a
                            token
  GET  /v1/model            model name/config summary
  POST /v1/generate         {"tokens": [[...]], "max_new_tokens": 32,
                             "temperature": 0.8, "top_k": 40, "seed": 0}
                            -> {"tokens": [[...]]}
                            headers X-KFT-Priority (interactive|standard|
                            batch) and X-KFT-Deadline-Seconds
  GET  /metrics             Prometheus text: the app's series, then the
                            process's compute series
                            (``telemetry/compute.py``: the attention
                            route counter, device memory)
  GET  /debug/traces        recent request span trees (?n=, ?trace_id=,
                            which also matches a trace's causal_trace_id)
  GET  /debug/profile       folded stacks of the registered sampling
                            profiler (telemetry/profiler.py): the open
                            window, ?window=N, or ?seconds=S captured now;
                            404 while no profiler is registered
  GET  /debug/serve         the engine that serves, its scheduler's stats
                            and the mesh's axis sizes

A request's ``traceparent`` header (W3C) is the handler thread's current
context (``telemetry/causal.py``) while the request runs, so its trace
links the caller's trace as ``causal_trace_id``.  The debug routes are
off with ``DEBUG_TRACES=0``.  The app registers no profiler itself: a
caller starts one and passes it to ``register_debug_profiler``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import threading
import time
from typing import Optional

import torch

from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
from kubeflow_tpu_torch.models.quantize import quantize_model, quantized_bytes
from kubeflow_tpu_torch.models.scheduler import (
    DEFAULT_PRIORITY,
    PRIORITY_CLASSES,
    DeadlineExceeded,
    DecodeScheduler,
)
from kubeflow_tpu_torch.parallel.lockstep import WorldBroken
from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.web.serve_app import (  # noqa: F401
    App,
    HttpError,
    Request,
    Response,
    failure,
    json_response,
    success,
)
from kubeflow_tpu_torch.telemetry import profiler
from kubeflow_tpu_torch.telemetry import compute as ctel  # /metrics
from kubeflow_tpu_torch.telemetry.metrics import Counter, Gauge, Histogram, Registry
from kubeflow_tpu_torch.telemetry.serve import (
    ServeTelemetry,
    filter_traces,
    span_or_null,
)

log = logging.getLogger("kubeflow_tpu_torch.serve")


def _validate_and_pad(rows, vocab: int, *, max_new_tokens, default_max,
                      limit_new, limit_source, top_k, eos_token,
                      limit_rows: int, device):
    """Request validation + right-padding.  Returns (tokens [b, longest]
    long, mask [b, longest] bool, n) on ``device``.  Size limits reject
    before the O(total tokens) scan."""
    if not rows or not isinstance(rows, list) or not all(
            isinstance(r, list) and r for r in rows):
        raise ValueError("tokens must be a non-empty list of non-empty rows")
    if limit_rows and len(rows) > limit_rows:
        raise ValueError(
            f"batch of {len(rows)} rows exceeds the service limit {limit_rows}")
    n = default_max if max_new_tokens is None else max_new_tokens
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        raise ValueError(f"max_new_tokens must be a positive int, got {n!r}")
    if limit_new and n > limit_new:
        raise ValueError(
            f"max_new_tokens {n} exceeds the service limit {limit_new}")
    longest = max(len(r) for r in rows)
    if limit_source and longest > limit_source:
        raise ValueError(
            f"input length {longest} exceeds the service limit {limit_source}")
    for r in rows:
        for t in r:
            # bool is an int subclass: JSON true/false must 400.
            if isinstance(t, bool) or not isinstance(t, int) \
                    or not 0 <= t < vocab:
                raise ValueError(f"token {t!r} outside [0, {vocab})")
    if top_k is not None and (not isinstance(top_k, int)
                              or isinstance(top_k, bool) or top_k < 1):
        raise ValueError(f"top_k must be a positive int, got {top_k!r}")
    if eos_token is not None and (isinstance(eos_token, bool)
                                  or not isinstance(eos_token, int)):
        raise ValueError(f"eos_token must be an int, got {eos_token!r}")
    tokens = torch.tensor([r + [0] * (longest - len(r)) for r in rows],
                          dtype=torch.long, device=device)
    mask = torch.tensor([[True] * len(r) + [False] * (longest - len(r))
                         for r in rows], dtype=torch.bool, device=device)
    return tokens, mask, n


# "Client did not set eos_token": resolved to the service's default.
_UNSET = object()


def _generated_token_count(rows, eos_token) -> int:
    """Tokens produced per row through the first EOS (post-EOS padding is
    not credited)."""
    if eos_token is None:
        return sum(len(r) for r in rows)
    return sum(r.index(eos_token) + 1 if eos_token in r else len(r)
               for r in rows)


def _check_deadline(deadline) -> None:
    if deadline is not None and time.monotonic() >= deadline:
        raise DeadlineExceeded(
            "request deadline expired while queued for the service lock")


def _lock_request(service, rows, eos_token, validate, run):
    """One request on the lock-serialized path, for both services: admit
    (``validate``, before the lock, so a bad request is refused without
    queueing) -> queue (the lock wait; queue depth counts its waiters) ->
    ``run(tel, t_arrival, *validate())`` under the lock -> the token
    counters.  With ``service.telemetry`` None (library use) every span
    and series is a no-op."""
    tel = service.telemetry
    t_arrival = time.perf_counter()
    if tel is not None:
        tel.begin_request()
    try:
        with span_or_null(tel, "admit"):
            args = validate()
            if tel is not None:
                tel.batch_rows.observe(len(rows))
                tel.batch_fill_ratio.observe(
                    len(rows) / max(service.max_batch_rows, 1))
                tel.input_tokens.inc(sum(len(r) for r in rows))
        with span_or_null(tel, "queue"):
            if tel is not None:
                tel.queue_depth.inc()
            try:
                service._lock.acquire()
            finally:
                if tel is not None:
                    tel.queue_depth.dec()
        try:
            result = run(tel, t_arrival, *args)
        finally:
            service._lock.release()
        if tel is not None:
            tel.output_tokens.inc(_generated_token_count(result, eos_token))
            tel.finish_request("ok")
        return result
    except BaseException:
        if tel is not None:
            tel.finish_request("error")
        raise


class _MeshService:
    """What both services share under a mesh: the mesh the model is
    sharded over and the lock-step channel of its processes (both None
    on one process), the follower's loop and ``close``."""

    mesh = None
    lockstep = None

    def mesh_shape(self) -> Optional[dict]:
        """The mesh's axis sizes, or None without one (``/debug/serve``)."""
        if self.mesh is None:
            return None
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))

    def _send(self, message) -> None:
        """Rank 0 under a mesh: one message to the followers' loop."""
        if self.lockstep is not None and self.lockstep.leader:
            self.lockstep.send(message)

    def _run_in_step(self, message, work):
        """``work()``, the lock path's device work.  Under a mesh rank 0
        first sends ``message`` (the request) to the followers' loop, and
        a failure after the send on any process aborts the world and
        raises ``WorldBroken``: the followers may be inside the same
        device work, so no later request may start.  Rank 0's followers
        then end at the abort, or when their collective fails as rank 0
        exits (``main``)."""
        if self.lockstep is None:
            return work()
        self._send(message)
        try:
            return work()
        except BaseException as exc:
            self.lockstep.abort(exc)
            raise WorldBroken(
                f"the lock-step world broke on rank {self.lockstep.rank}: "
                f"{exc!r}") from exc

    def follow(self) -> None:
        """A follower's loop (every process of the mesh but rank 0): run
        each request rank 0 sends, and the scheduler rank 0 starts, until
        rank 0 closes.  An error ends the loop by raising."""
        while True:
            message = self.lockstep.recv()
            if message[0] == "close":
                return
            if message[0] == "lock":
                self.generate(**message[1])
            elif message[0] == "scheduler":
                self._follower_scheduler(message[1], message[2]).follow()
            else:
                raise WorldBroken(f"unknown lock-step message {message!r}")

    def _follower_scheduler(self, kind, knobs):
        raise WorldBroken(f"{type(self).__name__} has no scheduler")

    def close(self) -> None:
        """Stop the scheduler; under a mesh, rank 0 then ends the
        followers' loops."""
        sched = getattr(self, "_scheduler", None)
        if sched is not None:
            sched.stop()
        ls = self.lockstep
        if ls is not None and ls.leader and ls.broken is None:
            with self._lock:
                ls.send(("close",))


class GenerationService(_MeshService):
    """Serves one decoder.  Requests are validated and right-padded, then
    either submitted to the continuous-batching scheduler (an
    instrumented service, unless pinned off) or run one at a time under
    a lock (prefill, then the decode loop)."""

    default_eos_token: Optional[int] = None
    # ServeTelemetry, attached by create_app; None = library use.
    telemetry: Optional[ServeTelemetry] = None

    def __init__(self, model, *, default_max_new_tokens: int = 32,
                 max_batch_rows: int = 64,
                 use_scheduler: Optional[bool] = None, draft_model=None,
                 quantize: Optional[str] = None, mesh=None, lockstep=None):
        self.model = model
        # The mesh the model is sharded over and the lock-step channel of
        # its processes (``load_service(mesh_spec=)``), or None.
        self.mesh = mesh
        self.lockstep = lockstep
        # The weights' quantization ("int8", done by load_service), or
        # None; /debug/serve reports it beside the weight bytes.
        self.quantize = quantize
        # The paged engine's speculative-decoding draft (same vocabulary).
        self.draft_model = draft_model
        # Why the fixed-slot pool serves instead of the paged engine
        # ({reason, detail}), or None: /debug/serve reports it and
        # serve_paged_fallback_total{reason} counts it.
        self.scheduler_fallback: Optional[dict] = None
        self.default_max_new_tokens = default_max_new_tokens
        self.max_batch_rows = max_batch_rows
        # None: KFT_SERVE_SCHEDULER decides (default on), per request.
        self.use_scheduler = use_scheduler
        self._scheduler: Optional[DecodeScheduler] = None
        self._scheduler_lock = threading.Lock()
        self._lock = threading.Lock()     # the lock path's

    def _scheduler_or_none(self) -> Optional[DecodeScheduler]:
        """The scheduler to route through, or None for the lock path: an
        un-instrumented service, a pinned one, or one whose scheduler
        died (failover instead of hanging clients)."""
        if self.telemetry is None:
            return None
        use = self.use_scheduler
        if use is None:
            use = config.env_bool("KFT_SERVE_SCHEDULER", True)
        if not use:
            return None
        with self._scheduler_lock:
            if self._scheduler is None:
                if self.lockstep is None:
                    self._scheduler = self._new_scheduler()
                else:
                    # No lock-path request may run on the devices while
                    # the followers switch to the scheduler's loop.
                    with self._lock:
                        self._scheduler = self._new_scheduler()
            sched = self._scheduler
        if not sched.alive and self.lockstep is not None:
            # Under a mesh a dead scheduler means a broken world: there is
            # no lock path to fail over to.
            raise WorldBroken("the lock-step world is broken") \
                from sched._dead
        return sched if sched.alive else None

    def _new_scheduler(self) -> DecodeScheduler:
        """The paged engine, unless ``KFT_SERVE_PAGED=0`` pins the
        fixed-slot pool or a draft model is asked for under a mesh
        (``spec-decode-mesh``: the draft is inert): each reason recorded
        and counted.  Under a mesh rank 0 sends the engine and its knobs
        to the followers, which build the same."""
        telemetry = lambda: self.telemetry
        reason = detail = None
        if not config.env_bool("KFT_SERVE_PAGED", True):
            reason = "env-disabled"
            detail = "KFT_SERVE_PAGED=0 pins the fixed-slot pool"
        elif self.mesh is not None and self.draft_model is not None:
            reason = "spec-decode-mesh"
            detail = ("speculative decoding is not mesh-aware; the "
                      "fixed-slot pool serves this mesh and the draft "
                      "model is inert")
        if reason is None:
            sched = PagedDecodeScheduler(
                self.model, telemetry=telemetry,
                draft_model=self.draft_model, mesh=self.mesh,
                lockstep=self.lockstep)
            self._send(("scheduler", "paged", sched.knobs()))
            return sched
        self.scheduler_fallback = {"reason": reason, "detail": detail}
        self.telemetry.paged_fallback.labels(reason=reason).inc()
        sched = DecodeScheduler(self.model, telemetry=telemetry,
                                mesh=self.mesh, lockstep=self.lockstep)
        self._send(("scheduler", "fixed", sched.knobs()))
        return sched

    def _follower_scheduler(self, kind, knobs) -> DecodeScheduler:
        """A follower's copy of the engine rank 0 started."""
        cls = PagedDecodeScheduler if kind == "paged" else DecodeScheduler
        self._scheduler = cls(self.model, mesh=self.mesh,
                              lockstep=self.lockstep, **knobs)
        return self._scheduler

    def _generate_scheduled(self, sched: DecodeScheduler, rows, validate, *,
                            temperature, top_k, eos_token, seed, priority,
                            deadline):
        """Submit to the scheduler and wait, mapping its admission,
        first-token and finish events onto the lock path's spans (admit,
        queue, prefill, decode), so traces and the TTFT and per-token
        series read alike under either engine."""
        tel = self.telemetry
        t_arrival = time.perf_counter()
        tel.begin_request()
        try:
            with tel.span("admit"):
                prompt, mask, n = validate()
                tel.batch_rows.observe(len(rows))
                tel.input_tokens.inc(sum(len(r) for r in rows))
            tel.slots_total.set(sched.slots)
            pending = sched.submit(
                rows, max_new_tokens=n, temperature=temperature,
                top_k=top_k, eos_token=eos_token, seed=seed,
                tokens=prompt, prompt_mask=mask, priority=priority,
                deadline=deadline)
            with tel.span("queue"):
                pending.wait_admitted()
            with tel.span("prefill", rows=len(rows)):
                pending.wait_first_token()
            tel.ttft.observe(pending.t_first - t_arrival)
            with tel.span("decode", tokens=n):
                result = pending.result()
            if n > 1:
                tel.per_token.observe(
                    (pending.t_done - pending.t_first) / (n - 1))
            tel.output_tokens.inc(_generated_token_count(result, eos_token))
            tel.finish_request("ok")
            return result
        except BaseException:
            tel.finish_request("error")
            raise

    def generate(self, rows, *, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_token=_UNSET, seed: int = 0,
                 priority: Optional[int] = None,
                 deadline: Optional[float] = None):
        """``priority`` is a ``PRIORITY_CLASSES`` value (the scheduler's
        admission order; the lock serializes in arrival order);
        ``deadline`` is an absolute ``time.monotonic()`` cutoff: a request
        still queued past it raises ``DeadlineExceeded``."""
        from kubeflow_tpu_torch.models.generate import (
            _check_cache_len,
            generate_decode,
            generate_prefill,
            row_generators,
        )

        if priority is None:
            priority = DEFAULT_PRIORITY
        if eos_token is _UNSET:
            eos_token = self.default_eos_token
        cfg = self.model.cfg
        device = self.model.device

        def validate():
            # prompt + new > max_seq_len also 400s via generate's own
            # cache-length check (a ValueError), and past the slot length
            # via the scheduler's.
            return _validate_and_pad(
                rows, cfg.vocab_size, max_new_tokens=max_new_tokens,
                default_max=self.default_max_new_tokens,
                limit_new=cfg.max_seq_len, limit_source=cfg.max_seq_len,
                top_k=top_k, eos_token=eos_token,
                limit_rows=self.max_batch_rows, device=device)

        sched = self._scheduler_or_none()
        if sched is not None:
            return self._generate_scheduled(
                sched, rows, validate, temperature=temperature, top_k=top_k,
                eos_token=eos_token, seed=seed, priority=priority,
                deadline=deadline)

        def run(tel, t_arrival, prompt, mask, n):
            _check_deadline(deadline)
            kw = dict(temperature=temperature, top_k=top_k,
                      eos_token=eos_token)
            if self.lockstep is not None:
                if self._scheduler is not None:
                    raise RuntimeError(
                        "under a mesh the lock path is closed once the "
                        "scheduler serves")
                # Validated on rank 0 before anything is sent.
                _check_cache_len(self.model, prompt.shape[1], n)

            def work():
                gens = row_generators(seed, prompt.shape[0], device)
                # Prefill and decode as separate spans; TTFT is the first
                # token's arrival on the host.
                with span_or_null(tel, "prefill", rows=prompt.shape[0]):
                    first, state = generate_prefill(
                        self.model, prompt, prompt_mask=mask,
                        max_new_tokens=n, generators=gens, **kw)
                    first.tolist()  # device -> host: where TTFT is read
                t_decode = time.perf_counter()
                with span_or_null(tel, "decode", tokens=n):
                    result = generate_decode(self.model, state,
                                             **kw).tolist()
                if tel is not None:
                    tel.ttft.observe(t_decode - t_arrival)
                    if n > 1:
                        tel.per_token.observe(
                            (time.perf_counter() - t_decode) / (n - 1))
                return result

            return self._run_in_step(
                ("lock", dict(rows=rows, max_new_tokens=n, seed=seed, **kw)),
                work)

        return _lock_request(self, rows, eos_token, validate, run)


class Seq2SeqGenerationService(_MeshService):
    """Serves one encoder-decoder (T5), the counterpart of the reference's
    ``Seq2SeqGenerationService`` (``kubeflow_tpu/models/serve.py:408-482``):
    the request contract of ``GenerationService``, but ``tokens`` rows are
    sources and the response is each row's generated target (BOS the pad
    id 0, EOS 1 unless the request sets ``eos_token``).

    Requests always run one at a time under the lock (``_lock_request``,
    one ``generate`` span: the encoder pass is not a prompt-cache
    prefill).  It has no scheduler branch, so neither
    ``KFT_SERVE_SCHEDULER`` nor ``KFT_SERVE_PAGED`` can route it: each
    decoder slot would need its own cross-attention K/V against a source
    of its own length, which the slot pools cannot hold.  T5 configs have
    no ``max_seq_len``, so the service bounds the target, the source and
    the rows, which size the caches and the encoder's O(S^2) work."""

    default_eos_token: Optional[int] = 1
    # ServeTelemetry, attached by create_app; None = library use.
    telemetry: Optional[ServeTelemetry] = None

    def __init__(self, model, *, default_max_new_tokens: int = 32,
                 max_target_len: int = 512, max_source_len: int = 4096,
                 max_batch_rows: int = 64, quantize: Optional[str] = None,
                 mesh=None, lockstep=None):
        self.model = model
        self.mesh = mesh
        self.lockstep = lockstep
        self.quantize = quantize
        self.default_max_new_tokens = default_max_new_tokens
        self.max_target_len = max_target_len
        self.max_source_len = max_source_len
        self.max_batch_rows = max_batch_rows
        self._lock = threading.Lock()

    def generate(self, rows, *, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 eos_token=_UNSET, seed: int = 0,
                 priority: Optional[int] = None,
                 deadline: Optional[float] = None):
        """``priority`` is accepted for the wire's sake and inert (the lock
        serializes in arrival order); a request whose ``deadline`` passed
        while it waited for the lock raises ``DeadlineExceeded``."""
        from kubeflow_tpu_torch.models.generate import (
            generate_seq2seq,
            row_generators,
        )

        del priority
        if eos_token is _UNSET:
            eos_token = self.default_eos_token
        device = self.model.device

        def validate():
            return _validate_and_pad(
                rows, self.model.cfg.vocab_size,
                max_new_tokens=max_new_tokens,
                default_max=self.default_max_new_tokens,
                limit_new=self.max_target_len,
                limit_source=self.max_source_len, top_k=top_k,
                eos_token=eos_token, limit_rows=self.max_batch_rows,
                device=device)

        def run(tel, t_arrival, source, mask, n):
            del t_arrival
            _check_deadline(deadline)

            def work():
                with span_or_null(tel, "generate", tokens=n):
                    return generate_seq2seq(
                        self.model, source, source_mask=mask,
                        max_new_tokens=n, temperature=temperature,
                        top_k=top_k, eos_token=eos_token,
                        generators=row_generators(seed, source.shape[0],
                                                  device)).tolist()

            return self._run_in_step(("lock", dict(
                rows=rows, max_new_tokens=n, temperature=temperature,
                top_k=top_k, eos_token=eos_token, seed=seed)), work)

        return _lock_request(self, rows, eos_token, validate, run)


def create_app(service, *, model_name: str = "model",
               revision: Optional[int] = None) -> App:
    """The serving app of a ``GenerationService`` or a
    ``Seq2SeqGenerationService``.  ``revision`` is exported as
    ``serve_replica_revision`` (default: KFT_SERVE_REVISION, else 0)."""
    app = App("model-serve")
    registry = Registry()
    requests_total = Counter(
        "generate_requests_total", "Generation requests by outcome",
        ["outcome"], registry=registry)
    request_seconds = Histogram(
        "generate_request_seconds", "Wall time of /v1/generate requests",
        registry=registry, buckets=(0.05, 0.2, 1, 5, 20, 60, 180))
    tokens_total = Counter(
        "generate_tokens_total", "Tokens generated", registry=registry)
    rejected_total = Counter(
        "generate_rejected_total",
        "Generation requests refused without running, by reason",
        ["reason"], registry=registry)
    if revision is None:
        revision = config.env_int("KFT_SERVE_REVISION", 0)
    Gauge("serve_replica_revision",
          "InferenceService revision this replica serves",
          registry=registry).set(revision)
    tel = ServeTelemetry(registry, component=model_name)
    service.telemetry = tel
    debug_traces_enabled = config.env_bool("DEBUG_TRACES", True)

    @app.route("/healthz")
    def healthz(request):
        return success({"healthy": True})

    # One-token warm generate, run once and cached: Ready means this
    # process has produced a token (weights on the card, kernels built).
    warm = {"done": False, "seconds": None, "error": None, "inflight": False}
    warm_lock = threading.Lock()

    @app.route("/readyz")
    def readyz(request):
        with warm_lock:
            if not warm["done"]:
                warm["inflight"] = True
                t0 = time.perf_counter()
                try:
                    service.generate([[1]], max_new_tokens=1)
                except Exception as e:  # noqa: BLE001 — report, don't 500
                    warm["error"] = f"{type(e).__name__}: {e}"
                else:
                    warm["error"] = None
                    warm["done"] = True
                finally:
                    warm["inflight"] = False
                warm["seconds"] = round(time.perf_counter() - t0, 3)
        if warm["error"] is not None:
            raise HttpError(503, f"warm generate failed: {warm['error']}")
        return success({"ready": True, "revision": revision,
                        "warm_generate_seconds": warm["seconds"]})

    @app.route("/debug/traces")
    def debug_traces(request):
        if not debug_traces_enabled:
            raise HttpError(404, "debug traces disabled")
        try:
            n = int(request.args.get("n", ""))
        except ValueError:
            n = None
        return json_response({"traces": filter_traces(
            tel.tracer.recent(), n=n,
            trace_id=request.args.get("trace_id"))})

    @app.route("/debug/profile")
    def debug_profile(request):
        # Folded stacks of the registered profiler: a request thread's
        # samples fold under the model's name through the Tracer seam.
        if not debug_traces_enabled:
            raise HttpError(404, "debug traces disabled")
        prof = profiler.debug_profiler()
        if prof is None:
            raise HttpError(404, "no profiler registered")
        body = None
        if request.args.get("seconds"):
            try:
                body = prof.capture(float(request.args["seconds"]))
            except ValueError:
                body = None
        elif request.args.get("window"):
            try:
                body = prof.folded(int(request.args["window"]))
            except ValueError:
                body = None
        else:
            body = prof.folded()
        if body is None:
            raise HttpError(404, "no such profile window")
        return 200, {"Content-Type": "text/plain; charset=utf-8"}, \
            body.encode()

    @app.route("/debug/serve")
    def debug_serve(request):
        # Which engine serves (None until the scheduler's first request,
        # and on the lock path), its live stats (pages, prefix cache,
        # speculative counts under the paged engine), and why the
        # fixed-slot pool serves when it does.
        if not debug_traces_enabled:
            raise HttpError(404, "debug traces disabled")
        sched = getattr(service, "_scheduler", None)
        return success({
            "engine": type(sched).__name__ if sched is not None else None,
            "scheduler": sched.stats() if sched is not None else None,
            "paged_fallback": getattr(service, "scheduler_fallback", None),
            "quantize": getattr(service, "quantize", None),
            "weight_bytes": quantized_bytes(service.model),
            "mesh": service.mesh_shape(),
        })

    @app.route("/metrics")
    def metrics(request):
        # The compute series are the process's: a pod's scraper reads
        # which attention route the replica ran from here.
        return 200, {"Content-Type": "text/plain; version=0.0.4"}, \
            (registry.render() + ctel.render()).encode()

    @app.route("/v1/model")
    def model_info(request):
        cfg = service.model.cfg
        return success({
            "model": model_name,
            "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                       if isinstance(v, (int, float, str, bool))},
        })

    def qos_headers(request):
        """(priority, absolute-monotonic deadline); ValueError -> 400."""
        priority = None
        name = request.headers.get("X-KFT-Priority")
        if name:
            if name not in PRIORITY_CLASSES:
                raise ValueError(
                    f"unknown priority class {name!r}; expected one of "
                    f"{sorted(PRIORITY_CLASSES)}")
            priority = PRIORITY_CLASSES[name]
        deadline = None
        raw = request.headers.get("X-KFT-Deadline-Seconds")
        if raw:
            try:
                secs = float(raw)
            except ValueError:
                raise ValueError(
                    f"malformed X-KFT-Deadline-Seconds {raw!r}") from None
            deadline = time.monotonic() + secs
        return priority, deadline

    @app.route("/v1/generate", methods=("POST",))
    def generate(request):
        body = request.get_json()
        if not isinstance(body, dict):
            body = {}
        t0 = time.perf_counter()
        try:
            if warm["inflight"] and not warm["done"]:
                rejected_total.labels(reason="warming").inc()
                return failure(
                    "replica not warm: /readyz warm generate in flight",
                    503, headers={"Retry-After": "2"})
            try:
                priority, deadline = qos_headers(request)
            except ValueError as e:
                requests_total.labels(outcome="invalid").inc()
                raise HttpError(400, str(e)) from None
            if deadline is not None and time.monotonic() >= deadline:
                rejected_total.labels(reason="deadline").inc()
                requests_total.labels(outcome="deadline").inc()
                return failure("request deadline already expired", 504)
            return run_generate(body, priority, deadline)
        finally:
            request_seconds.observe(time.perf_counter() - t0)

    def run_generate(body, priority, deadline):
        try:
            kwargs = {}
            if "eos_token" in body:
                kwargs["eos_token"] = body["eos_token"]
            tokens = service.generate(
                body.get("tokens"),
                max_new_tokens=body.get("max_new_tokens"),
                temperature=float(body.get("temperature", 0.0)),
                top_k=body.get("top_k"),
                seed=int(body.get("seed", 0)),
                priority=priority, deadline=deadline, **kwargs)
        except DeadlineExceeded as e:
            rejected_total.labels(reason="deadline").inc()
            requests_total.labels(outcome="deadline").inc()
            return failure(str(e), 504)
        except (ValueError, TypeError) as e:
            requests_total.labels(outcome="invalid").inc()
            raise HttpError(400, str(e)) from None
        except Exception:
            requests_total.labels(outcome="error").inc()
            raise
        requests_total.labels(outcome="ok").inc()
        eos = body.get("eos_token", service.default_eos_token)
        tokens_total.inc(_generated_token_count(tokens, eos))
        return success({"tokens": tokens})

    return app


def load_service(model_name: str, *, device="cuda",
                 max_seq_len: Optional[int] = None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 quantize: Optional[str] = None,
                 mesh_spec: Optional[str] = None,
                 draft_model_name: Optional[str] = None,
                 draft_checkpoint_dir: Optional[str] = None,
                 use_scheduler: Optional[bool] = None,
                 n_layers: Optional[int] = None):
    """Build the model on ``device`` (default the card; raises without
    one).  Its weights are the latest checkpoint's parameters under
    ``checkpoint_dir`` (read without the optimizer state, cast to the
    serving dtype; raises ``FileNotFoundError`` when there is none), else
    random, drawn from ``seed`` directly on the device (an 8B init on the
    host would take minutes).

    A decoder returns a ``GenerationService``; an encoder-decoder (a model
    with ``encode``, T5) a ``Seq2SeqGenerationService``.  A knob the
    model's config lacks (T5 has neither ``max_seq_len`` nor
    ``n_layers``) raises instead of being dropped.

    ``quantize="int8"`` stores the target's matmul and embedding weights
    as int8 with per-channel scales (``models/quantize.py``), dequantized
    at use; from a checkpoint they are quantized from its saved (f32)
    values, as the reference quantizes its f32 parameters.  The draft
    stays unquantized, as in the reference.  ``n_layers`` cuts the
    target's depth (its width stays the config's).

    ``draft_model_name`` builds a second, smaller decoder of the same
    vocabulary for speculative decoding under the paged engine, restored
    from ``draft_checkpoint_dir`` or drawn from ``seed`` the same way; a
    vocabulary mismatch, a seq2seq draft or a seq2seq target fails here,
    at startup.

    ``mesh_spec`` ("tp=2", "tp=2,fsdp=2", "ep=2", "auto") serves the model
    sharded over a mesh of the world's processes, every one of which
    calls this function: quantization with a mesh and a malformed spec
    raise ``ValueError`` before anything is built; then the process joins
    the world (``parallel.dist.initialize_from_env``; an initialized group
    is used as it is, and without either a launcher's env raises),
    the spec is resolved over the world size, and each process builds
    only its shards of the model by the family's rules
    (``sharding.shard_for_serving``), drawn from ``seed`` or read slice by
    slice from the checkpoint.  The service carries the mesh and the
    lock-step channel (``parallel/lockstep.py``): rank 0 serves, every
    other process runs ``service.follow()``.  A draft model is built
    whole on every process and stays inert (``spec-decode-mesh``)."""
    from kubeflow_tpu_torch import resolve_device
    from kubeflow_tpu_torch.models import create_model

    if quantize and quantize != "int8":
        raise ValueError(f"unsupported quantization {quantize!r} (int8)")
    if mesh_spec:
        # Before anything is built: a typo must fail in milliseconds.
        from kubeflow_tpu_torch.train.run import mesh_axes

        if quantize:
            raise ValueError(
                "--mesh with --quantize is not supported: the int8 weights "
                "carry per-channel scales with no partition rule")
        mesh_axes(mesh_spec)
    dev = resolve_device(device)
    overrides = {"max_seq_len": max_seq_len} if max_seq_len else {}
    if n_layers:
        overrides["n_layers"] = n_layers
    # The config's knobs are checked on a build without storage: the full
    # model may not fit the card its cut (``n_layers``) is served on.
    shapes = create_model(model_name, device="meta")
    for knob in overrides:
        if not hasattr(shapes.cfg, knob):
            raise ValueError(f"{model_name} has no {knob} config; drop "
                             f"--{knob.replace('_', '-')}")
    seq2seq = hasattr(shapes, "encode")
    if seq2seq and draft_model_name:
        raise ValueError(
            "--draft-model applies to decoder-only serving; seq2seq models "
            "have no speculative-decoding path")
    mesh = lockstep = None
    if mesh_spec:
        mesh, lockstep, model = _load_sharded(
            model_name, mesh_spec, dev, overrides, checkpoint_dir, seed)
    else:
        model = _load_model(create_model(model_name, device=dev,
                                         **overrides),
                            checkpoint_dir, seed, quantize=bool(quantize))
    if seq2seq:
        return Seq2SeqGenerationService(model, quantize=quantize or None,
                                        mesh=mesh, lockstep=lockstep)
    draft = None
    if draft_model_name:
        draft = create_model(draft_model_name, device=dev)
        if hasattr(draft, "encode"):
            raise ValueError(
                f"draft model {draft_model_name} is seq2seq; speculative "
                f"decoding needs a decoder-only draft")
        if draft.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft.cfg.vocab_size} != target vocab "
                f"{model.cfg.vocab_size}: the draft's proposals must index "
                f"the target's token space")
        draft = _load_model(draft, draft_checkpoint_dir, seed)
    return GenerationService(model, use_scheduler=use_scheduler,
                             draft_model=draft, quantize=quantize or None,
                             mesh=mesh, lockstep=lockstep)


def _join_world(dev: torch.device) -> None:
    """Join the deployment's process group unless this process is in one,
    from the platform's or torchrun's env (``initialize_from_env``);
    without either there is no world to lay a mesh over."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.dist import initialize_from_env

    if dist.is_initialized() or initialize_from_env(device_type=dev.type):
        return
    raise RuntimeError(
        "--mesh serves over a world of processes, one a device, and this "
        "process has no launcher's env: run every process under torchrun "
        "(torchrun --nproc-per-node N -m kubeflow_tpu_torch.models.serve "
        "--mesh ...) or the platform's multi-host env")


def _load_sharded(model_name: str, mesh_spec: str, dev: torch.device,
                  overrides: dict, checkpoint_dir: Optional[str], seed: int):
    """``(mesh, lockstep, model)``: join the world, lay the mesh over it,
    and build this process's shards of the model by its family's rules,
    from the seed or from the latest checkpoint's files read slice by
    slice.  The mesh becomes the process's global mesh."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.parallel.context import set_global_mesh
    from kubeflow_tpu_torch.parallel.lockstep import Lockstep
    from kubeflow_tpu_torch.parallel.mesh import make_mesh, world_size
    from kubeflow_tpu_torch.parallel.sharding import (
        rules_for_model,
        shard_for_serving,
    )
    from kubeflow_tpu_torch.train.run import parse_mesh

    _join_world(dev)
    mesh = make_mesh(parse_mesh(mesh_spec, world_size()),
                     device_type=dev.type)
    model = create_model(model_name, device="meta", **overrides)
    rules = rules_for_model(model)
    if checkpoint_dir:
        from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

        with CheckpointManager(checkpoint_dir) as mgr:
            source = mgr.restore_params()
        if source is None:
            raise FileNotFoundError(
                f"no checkpoint found under {checkpoint_dir}")
        shard_for_serving(model, mesh, rules, device=dev, source=source)
    else:
        shard_for_serving(model, mesh, rules, device=dev, seed=seed)
    set_global_mesh(mesh)
    return mesh, Lockstep(), model.eval()


def _load_model(model, checkpoint_dir: Optional[str], seed: int, *,
                quantize: bool = False):
    """``model`` in eval mode with the latest checkpoint's parameters
    under ``checkpoint_dir``, else random ones drawn from ``seed``; with
    ``quantize``, int8 (from the checkpoint's saved values when there is
    one)."""
    source = None
    if checkpoint_dir:
        from kubeflow_tpu_torch.train.checkpoint import (
            CheckpointManager,
            load_params,
        )

        with CheckpointManager(checkpoint_dir) as mgr:
            source = mgr.restore_params()
        if source is None:
            raise FileNotFoundError(
                f"no checkpoint found under {checkpoint_dir}")
        load_params(model, source)
    else:
        gen = torch.Generator(device=model.device).manual_seed(seed)
        with torch.no_grad():
            model.reset_parameters(gen)
    if quantize:
        quantize_model(model, source=source)
    return model.eval()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--model", default="llama_125m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="serve the latest checkpoint's parameters here "
                         "(train.run --checkpoint-dir)")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="weight-only int8 with per-channel scales, "
                         "dequantized at use")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model's depth to this many layers (its "
                         "width stays the config's)")
    ap.add_argument("--mesh", default=None,
                    help="serve sharded over a mesh of the world's "
                         "processes (e.g. tp=2, tp=2,fsdp=2, ep=2, auto); "
                         "every process runs this command (torchrun, or "
                         "the platform's env): rank 0 serves HTTP, the "
                         "others follow it")
    ap.add_argument("--draft-model", default=None,
                    help="small same-vocab decoder for speculative "
                         "decoding under the paged engine "
                         "(KFT_SERVE_SPEC_TOKENS proposals a step)")
    ap.add_argument("--draft-checkpoint-dir", default=None,
                    help="checkpoint for --draft-model (random weights "
                         "from --seed when omitted)")
    args = ap.parse_args(argv)
    try:
        service = load_service(
            args.model, device=args.device, max_seq_len=args.max_seq_len,
            seed=args.seed, checkpoint_dir=args.checkpoint_dir,
            quantize=args.quantize, mesh_spec=args.mesh,
            draft_model_name=args.draft_model,
            draft_checkpoint_dir=args.draft_checkpoint_dir,
            n_layers=args.n_layers)
    except (ValueError, KeyError, NotImplementedError, RuntimeError,
            FileNotFoundError) as e:
        ap.error(str(e))
    lockstep = service.lockstep
    if lockstep is not None and not lockstep.leader:
        # A follower binds no port: it runs rank 0's requests until rank
        # 0 closes (or an error ends the world).
        print(json.dumps({"following": args.model, "rank": lockstep.rank,
                          "mesh": service.mesh_shape()}), flush=True)
        service.follow()
        return 0
    server = create_app(service, model_name=args.model).make_server(
        args.host, args.port)
    print(json.dumps({"serving": args.model, "port": args.port,
                      "device": str(service.model.device),
                      "quantize": service.quantize,
                      "mesh": service.mesh_shape(),
                      "weight_bytes": quantized_bytes(service.model)}),
          flush=True)
    if lockstep is not None:
        threading.Thread(target=_shutdown_when_broken,
                         args=(lockstep, server), daemon=True,
                         name="kft-lockstep-watch").start()
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if lockstep is not None and lockstep.broken is None:
            service.close()
    return 1 if lockstep is not None and lockstep.broken is not None else 0


def _shutdown_when_broken(lockstep, server) -> None:
    """Rank 0's watch: a broken lock-step world stops the server, so the
    process exits and its peers' waits end."""
    while lockstep.broken is None:
        time.sleep(0.5)
    server.shutdown()


if __name__ == "__main__":
    sys.exit(main())
