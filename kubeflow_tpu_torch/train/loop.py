"""The port's training loop: steps, log lines, tokens/s, MFU, checkpoints
with resume, eval, step traces and the slow-step profiler.

Counterpart of ``kubeflow_tpu/train/loop.py``.  With ``checkpoint_dir``
the loop resumes from the latest step there (a callable ``batches`` gets
the step to start from, so a step-indexed stream replays exactly), saves
every ``checkpoint_every`` steps (``train/checkpoint.py``) and, when it
ends or is stopped, saves the state's own step unless an interval save
already did.  PyTorch runs eagerly and the card runs behind the host, so
the loop syncs only on log steps: there it reads the metrics (a
device-to-host copy that waits for the step), and the window since the
previous log step gives the step seconds, tokens/s and MFU.

Every step is a trace of ``telemetry.compute.train_tracer``: ``data``
(the next batch), ``dispatch`` (the step call) and ``bookkeeping`` (the
log step's read, the checkpoint, eval).  The step's time is data +
dispatch on the host, observed in ``train_step_seconds``; a step at or
over ``TRAIN_SLOW_STEP_SECONDS`` dumps its span tree as one JSON log
line, counts in ``train_slow_steps_total``, and, once a run, has the
NEXT step recorded by ``torch.profiler`` into ``slow_step_profile_dir``
(or ``$KFT_SLOW_STEP_PROFILE_DIR``).  Every ``eval_every`` steps
``eval_fn`` runs over ``eval_steps`` batches of ``eval_batches()`` and
the means enter the history as ``eval_``-prefixed entries.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.telemetry import compute as ctel

log = logging.getLogger("kubeflow_tpu_torch.train")

ENV_SLOW_STEP_PROFILE_DIR = "KFT_SLOW_STEP_PROFILE_DIR"


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    max_to_keep: int = 3
    eval_every: int = 0          # 0 disables
    eval_steps: int = 10
    # Tokens per optimizer step; inferred from a [batch, seq] integer
    # token batch when unset.  Gates the tokens/s value.
    tokens_per_step: Optional[int] = None
    # Model FLOPs per token (telemetry.compute.lm_train_flops_per_token);
    # gates the MFU value.
    flops_per_token: Optional[float] = None
    # Record the step after a slow one with torch.profiler (once a run);
    # falls back to $KFT_SLOW_STEP_PROFILE_DIR.
    slow_step_profile_dir: Optional[str] = None


def logfmt(event: str, **fields) -> str:
    """``event key=value ...`` with floats at %.6g (the reference's
    structured line, ``kubeflow_tpu/telemetry/__init__.py``)."""
    parts = [event]
    for k, v in fields.items():
        parts.append(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}")
    return " ".join(parts)


def _default_log(step: int, vals: Dict[str, float]) -> None:
    line = logfmt("train_step", step=step,
                  **{k: v for k, v in vals.items() if k != "step"})
    log.info("%s", line)
    print(line, flush=True)


def train_loop(state, step_fn: Callable, batches, cfg: LoopConfig, *,
               eval_fn: Optional[Callable] = None,
               eval_batches: Optional[Callable[[], Iterable]] = None,
               on_log: Optional[Callable[[int, Dict], None]] = None,
               stop=None):
    """Run ``step_fn(state, batch) -> (state, metrics)`` for
    ``cfg.total_steps`` steps, counted from the restored step when
    resuming.  ``batches`` is an iterable, or a callable taking the start
    step.  ``eval_fn(state, batch) -> metrics`` runs every
    ``cfg.eval_every`` steps over ``eval_batches()``.  ``stop`` (a
    ``threading.Event``, or ``parallel/dist.py``'s ``AgreedStop`` in a
    world of processes) is checked between steps; the loop then exits and
    saves.  Returns ``(state, history)``: one ``{"step": n, ...}`` entry
    per log step with the metrics, ``step_seconds``, ``steps_per_sec``,
    ``tokens_per_sec`` and, given the FLOPs, ``mfu``; and one per eval
    with the ``eval_``-prefixed means."""
    manager = None
    start_step = 0
    if cfg.checkpoint_dir:
        from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

        manager = CheckpointManager(
            cfg.checkpoint_dir, max_to_keep=cfg.max_to_keep,
            save_interval_steps=cfg.checkpoint_every)
        if manager.restore(state) is not None:
            start_step = int(state.step)
            log.info("resumed from checkpoint at step %d", start_step)
    history: List[Dict[str, Any]] = []
    it = iter(batches(start_step) if callable(batches) else batches)
    t0 = time.perf_counter()
    window_started_at = start_step
    tokens_per_step = cfg.tokens_per_step
    profile_dir = cfg.slow_step_profile_dir or config.knob(
        ENV_SLOW_STEP_PROFILE_DIR, None,
        doc="directory for slow-step profiler dumps") or None
    profile_next = profile_done = False
    tracer = ctel.train_tracer
    try:
        for step in range(start_step, cfg.total_steps):
            if stop is not None and stop.is_set():
                log.info("stop requested at step %d", step)
                break
            now = step + 1
            t_iter = time.perf_counter()
            # The first step of a loop pays the allocator's warm-up and
            # cuDNN's algorithm choice; "first" keeps it out of "run".
            phase = "first" if step == start_step else "run"
            tracer.begin(str(now), enabled=ctel.STEP_TRACE_ENABLED)
            try:
                with tracer.span("data"):
                    batch = next(it)
            except StopIteration:
                tracer.finish("data_exhausted")
                log.info("data exhausted at step %d", step)
                break
            if tokens_per_step is None:
                tokens_per_step = _tokens_in_batch(batch)
            with tracer.span("dispatch", phase=phase):
                if profile_next and not profile_done:
                    profile_next, profile_done = False, True
                    with _auto_profile(profile_dir), \
                            tracer.span("profile", logdir=profile_dir):
                        state, metrics = step_fn(state, batch)
                        _barrier(metrics)
                else:
                    state, metrics = step_fn(state, batch)
            # Data + dispatch only: the log step's read below waits for
            # the whole window's device work, and counting it would flag
            # every log_every-th step as slow.  It stays visible as the
            # bookkeeping span.
            dt_step = time.perf_counter() - t_iter
            with tracer.span("bookkeeping"):
                if cfg.log_every and now % cfg.log_every == 0:
                    vals = {k: float(v) for k, v in metrics.items()}
                    dt = max(time.perf_counter() - t0, 1e-9)
                    n_window = now - window_started_at
                    vals["step_seconds"] = dt / n_window
                    vals["steps_per_sec"] = n_window / dt
                    if tokens_per_step:
                        vals.update(ctel.update_throughput(
                            tokens_per_step * n_window / dt,
                            flops_per_token=cfg.flops_per_token))
                    history.append({"step": now, **vals})
                    (on_log or _default_log)(now, vals)
                    t0 = time.perf_counter()
                    window_started_at = now
                if manager is not None:
                    manager.save(now, state)
                if (cfg.eval_every and eval_fn is not None
                        and now % cfg.eval_every == 0):
                    vals = _run_eval(eval_fn, state, eval_batches,
                                     cfg.eval_steps)
                    entry = {"step": now,
                             **{f"eval_{k}": v for k, v in vals.items()}}
                    history.append(entry)
                    (on_log or _default_log)(now, entry)
            ctel.observe_step(dt_step, phase=phase)
            slow = dt_step >= ctel.TRAIN_SLOW_STEP_SECONDS
            tracer.finish("ok", slow_seconds=(ctel.TRAIN_SLOW_STEP_SECONDS
                                              if slow else None))
            if slow:
                ctel.train_slow_steps_total.inc()
                if profile_dir and not profile_done:
                    # Record the NEXT step: this one has run, and a repeat
                    # of what stalled it is what the profile should catch.
                    profile_next = True
    finally:
        if manager is not None:
            # The state's own count, not the loop's: a stop breaks at the
            # top of an iteration, one step past what the state holds.
            final = int(state.step)
            if manager.latest_step() != final:
                manager.save(final, state, force=True)
            manager.close()
            if manager.last_save is not None:
                line = logfmt("checkpoint", **manager.last_save)
                log.info("%s", line)
                print(line, flush=True)
    return state, history


def _run_eval(eval_fn, state, eval_batches, eval_steps) -> Dict[str, float]:
    """The mean of each metric of ``eval_fn`` over at most ``eval_steps``
    batches of ``eval_batches()``."""
    sums: Dict[str, float] = {}
    n = 0
    source = eval_batches() if eval_batches is not None else []
    for i, batch in enumerate(source):
        if i >= eval_steps:
            break
        for k, v in eval_fn(state, batch).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def _tokens_in_batch(batch) -> Optional[int]:
    """Tokens an LM step consumes: a [batch, seq] integer tensor, or the
    first element of a (tokens, segment_ids) pair.  None for any other
    batch (images, whose first element is 4-D float), so the tokens/s
    value stays unset unless ``LoopConfig.tokens_per_step`` is given."""
    if isinstance(batch, (tuple, list)):
        if not batch:
            return None
        batch = batch[0]
    shape = getattr(batch, "shape", None)
    dtype = getattr(batch, "dtype", None)
    if shape is None or dtype is None or len(shape) != 2:
        return None
    if "int" not in str(dtype):
        return None
    return int(shape[0]) * int(shape[1])


def _barrier(metrics) -> None:
    """Wait for the step's device work so the profiled step lands inside
    the capture: reading one metric to the host waits for it."""
    for v in (metrics or {}).values():
        float(v)
        return


@contextmanager
def _auto_profile(logdir: Optional[str]):
    """Best-effort ``torch.profiler`` capture around the step after a slow
    one: a profiler failure is logged and swallowed, since a diagnostic
    must not kill (or re-run) the step it wraps.  The strict interactive
    form is ``train/profiling.py`` ``profile_trace``."""
    if not logdir:
        yield
        return
    from kubeflow_tpu_torch.train import profiling

    capture = None
    try:
        capture = profiling.start_trace(logdir)
    except Exception:  # noqa: BLE001 — a diagnostic must not stop training
        log.warning("slow-step profile: start failed", exc_info=True)
    try:
        yield
    finally:
        if capture is not None:
            try:
                log.info("slow-step profile written to %s", capture.stop())
            except Exception:  # noqa: BLE001
                log.warning("slow-step profile: stop failed", exc_info=True)
