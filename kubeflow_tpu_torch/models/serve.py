"""Generation server: serve a decoder of the model zoo over HTTP, in
PyTorch on the card.

    python -m kubeflow_tpu_torch.models.serve --model llama3_8b --port 8080

Counterpart of ``kubeflow_tpu/models/serve.py``.  An instrumented
service (the app of ``create_app``) routes every request through the
fixed-slot continuous-batching ``DecodeScheduler``
(``models/scheduler.py``) unless ``KFT_SERVE_SCHEDULER=0`` (or
``use_scheduler=False``) pins the lock-serialized path; library use of a
bare ``GenerationService`` takes the lock path.  The paged engine is not
ported yet, so the port serves as the reference does under
``KFT_SERVE_PAGED=0``.  A scheduler whose loop crashed fails over to the
lock path.  The server is the standard library's ``ThreadingHTTPServer``;
weights are random, drawn from ``--seed`` on the device, unless
``--checkpoint-dir`` names a trainer's checkpoints
(``train/checkpoint.py``), whose latest parameters are restored in the
serving dtype.

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
  GET  /metrics             Prometheus text
  GET  /debug/traces        recent request span trees (?n=, ?trace_id=)
  GET  /debug/serve         the engine that serves and its scheduler's stats
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import torch

from kubeflow_tpu_torch import config
from kubeflow_tpu_torch.models.scheduler import (
    DEFAULT_PRIORITY,
    PRIORITY_CLASSES,
    DeadlineExceeded,
    DecodeScheduler,
)
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


class GenerationService:
    """Serves one decoder.  Requests are validated and right-padded, then
    either submitted to the continuous-batching scheduler (an
    instrumented service, unless pinned off) or run one at a time under
    a lock (prefill, then the decode loop)."""

    default_eos_token: Optional[int] = None
    # ServeTelemetry, attached by create_app; None = library use.
    telemetry: Optional[ServeTelemetry] = None

    def __init__(self, model, *, default_max_new_tokens: int = 32,
                 max_batch_rows: int = 64,
                 use_scheduler: Optional[bool] = None):
        self.model = model
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
            use = config.env_bool(*config.SERVE_SCHEDULER)
        if not use:
            return None
        with self._scheduler_lock:
            if self._scheduler is None:
                self._scheduler = DecodeScheduler(
                    self.model, telemetry=lambda: self.telemetry)
            sched = self._scheduler
        return sched if sched.alive else None

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
        tel = self.telemetry
        t_arrival = time.perf_counter()
        if tel is not None:
            tel.begin_request()
        try:
            with span_or_null(tel, "admit"):
                prompt, mask, n = validate()
                if tel is not None:
                    tel.batch_rows.observe(len(rows))
                    tel.batch_fill_ratio.observe(
                        len(rows) / max(self.max_batch_rows, 1))
                    tel.input_tokens.inc(sum(len(r) for r in rows))
            with span_or_null(tel, "queue"):
                if tel is not None:
                    tel.queue_depth.inc()
                try:
                    self._lock.acquire()
                finally:
                    if tel is not None:
                        tel.queue_depth.dec()
            try:
                _check_deadline(deadline)
                kw = dict(temperature=temperature, top_k=top_k,
                          eos_token=eos_token)
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
                t_done = time.perf_counter()
            finally:
                self._lock.release()
            if tel is not None:
                tel.ttft.observe(t_decode - t_arrival)
                if n > 1:
                    tel.per_token.observe((t_done - t_decode) / (n - 1))
                tel.output_tokens.inc(_generated_token_count(result,
                                                             eos_token))
                tel.finish_request("ok")
            return result
        except BaseException:
            if tel is not None:
                tel.finish_request("error")
            raise


# -- a minimal HTTP app on the standard library ------------------------------


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclasses.dataclass
class Request:
    args: Dict[str, str]
    headers: object  # email.message.Message: case-insensitive .get
    body: bytes

    def get_json(self):
        """The body as JSON, or None when it is not valid JSON."""
        try:
            return json.loads(self.body or b"null")
        except ValueError:
            return None


Response = Tuple[int, Dict[str, str], bytes]


def json_response(data, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    return status, h, json.dumps(data).encode()


def success(data: Optional[dict] = None, status: int = 200) -> Response:
    body = {"success": True, "status": status}
    body.update(data or {})
    return json_response(body, status)


def failure(message: str, status: int = 400,
            headers: Optional[Dict[str, str]] = None) -> Response:
    return json_response({"success": False, "status": status, "log": message,
                          "user_action": message}, status, headers)


class App:
    """Routes (method, path) to handlers ``fn(request) -> Response``."""

    def __init__(self, name: str):
        self.name = name
        self.routes: Dict[str, Dict[str, Callable]] = {}

    def route(self, path: str, methods=("GET",)):
        def deco(fn):
            for m in methods:
                self.routes.setdefault(path, {})[m] = fn
            return fn
        return deco

    def handle(self, method: str, target: str, headers,
               body: bytes) -> Response:
        url = urlsplit(target)
        args = {k: v[-1] for k, v in parse_qs(url.query).items()}
        handlers = self.routes.get(url.path)
        if handlers is None:
            return failure(f"no route {url.path}", 404)
        fn = handlers.get(method)
        if fn is None:
            return failure(f"method {method} not allowed", 405)
        try:
            return fn(Request(args, headers, body))
        except HttpError as e:
            return failure(e.message, e.status)
        except Exception as e:  # noqa: BLE001 — the server must keep serving
            log.exception("%s %s failed", method, url.path)
            return failure(f"{type(e).__name__}: {e}", 500)

    def make_server(self, host: str = "127.0.0.1",
                    port: int = 0) -> ThreadingHTTPServer:
        """A threaded HTTP server for this app (port 0: any free port,
        read it back from ``server.server_address``)."""
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _dispatch(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                status, headers, payload = app.handle(
                    self.command, self.path, self.headers, body)
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = _dispatch

            def log_message(self, fmt, *args):
                log.debug("%s " + fmt, self.address_string(), *args)

        server = ThreadingHTTPServer((host, port), Handler)
        server.daemon_threads = True
        return server


def create_app(service: GenerationService, *, model_name: str = "model",
               revision: Optional[int] = None) -> App:
    """The serving app.  ``revision`` is exported as
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

    @app.route("/debug/serve")
    def debug_serve(request):
        # Which engine serves (None until the scheduler's first request,
        # and on the lock path) and its live stats.
        if not debug_traces_enabled:
            raise HttpError(404, "debug traces disabled")
        sched = service._scheduler
        return success({
            "engine": type(sched).__name__ if sched is not None else None,
            "scheduler": sched.stats() if sched is not None else None,
            "paged": "not ported: the fixed-slot pool serves",
        })

    @app.route("/metrics")
    def metrics(request):
        return 200, {"Content-Type": "text/plain; version=0.0.4"}, \
            registry.render().encode()

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
                 use_scheduler: Optional[bool] = None) -> GenerationService:
    """Build the model on ``device`` (default the card; raises without
    one).  Its weights are the latest checkpoint's parameters under
    ``checkpoint_dir`` (read without the optimizer state, cast to the
    serving dtype; raises ``FileNotFoundError`` when there is none), else
    random, drawn from ``seed`` directly on the device (an 8B init on the
    host would take minutes)."""
    from kubeflow_tpu_torch import resolve_device
    from kubeflow_tpu_torch.models import create_model

    for flag, value in (("--quantize", quantize), ("--mesh", mesh_spec),
                        ("--draft-model", draft_model_name)):
        if value:
            raise NotImplementedError(
                f"{flag} is not yet ported to kubeflow_tpu_torch; see "
                "ROADMAP.md")
    dev = resolve_device(device)
    overrides = {"max_seq_len": max_seq_len} if max_seq_len else {}
    model = create_model(model_name, device=dev, **overrides)
    if checkpoint_dir:
        from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

        with CheckpointManager(checkpoint_dir) as mgr:
            if mgr.restore_params(template=model) is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {checkpoint_dir}")
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            model.reset_parameters(gen)
    return GenerationService(model.eval(), use_scheduler=use_scheduler)


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
                    help="not yet ported")
    ap.add_argument("--mesh", default=None, help="not yet ported")
    ap.add_argument("--draft-model", default=None, help="not yet ported")
    args = ap.parse_args(argv)
    try:
        service = load_service(
            args.model, device=args.device, max_seq_len=args.max_seq_len,
            seed=args.seed, checkpoint_dir=args.checkpoint_dir,
            quantize=args.quantize, mesh_spec=args.mesh,
            draft_model_name=args.draft_model)
    except (ValueError, KeyError, NotImplementedError, RuntimeError,
            FileNotFoundError) as e:
        ap.error(str(e))
    server = create_app(service, model_name=args.model).make_server(
        args.host, args.port)
    print(json.dumps({"serving": args.model, "port": args.port,
                      "device": str(service.model.device)}), flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
