"""The port's training loop: steps, log lines, tokens/s, MFU and
checkpoints with resume.

Counterpart of ``kubeflow_tpu/train/loop.py`` without eval or the
slow-step profiler (not yet ported).  With ``checkpoint_dir`` the loop
resumes from the latest step there (a callable ``batches`` gets the step
to start from, so a step-indexed stream replays exactly), saves every
``checkpoint_every`` steps (``train/checkpoint.py``) and, when it ends or
is stopped, saves the state's own step unless an interval save already
did.  PyTorch runs eagerly and the
card runs behind the host, so the loop syncs only on log steps: there it
reads the metrics (a device-to-host copy that waits for the step), and
the window since the previous log step gives the step seconds, tokens/s
and MFU.  The per-step histogram observes data + dispatch on the host.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

from kubeflow_tpu_torch.telemetry import compute as ctel

log = logging.getLogger("kubeflow_tpu_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    max_to_keep: int = 3
    # Tokens per optimizer step; gates the tokens/s value.
    tokens_per_step: Optional[int] = None
    # Model FLOPs per token (telemetry.compute.lm_train_flops_per_token);
    # gates the MFU value.
    flops_per_token: Optional[float] = None


def logfmt(event: str, **fields) -> str:
    """``event key=value ...`` with floats at %.6g (the reference's
    structured line, ``kubeflow_tpu/telemetry/__init__.py``)."""
    parts = [event]
    for k, v in fields.items():
        parts.append(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}")
    return " ".join(parts)


def _default_log(step: int, vals: Dict[str, float]) -> None:
    line = logfmt("train_step", step=step, **vals)
    log.info("%s", line)
    print(line, flush=True)


def train_loop(state, step_fn: Callable, batches, cfg: LoopConfig, *,
               on_log: Optional[Callable[[int, Dict], None]] = None,
               stop=None):
    """Run ``step_fn(state, batch) -> (state, metrics)`` for
    ``cfg.total_steps`` steps, counted from the restored step when
    resuming.  ``batches`` is an iterable, or a callable taking the start
    step.  ``stop`` (a ``threading.Event``) is checked between steps; the
    loop then exits and saves.  Returns ``(state, history)``, one
    ``{"step": n, ...}`` entry per log step with the metrics,
    ``step_seconds``, ``steps_per_sec``, ``tokens_per_sec`` and, given the
    FLOPs, ``mfu``."""
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
    try:
        for step in range(start_step, cfg.total_steps):
            if stop is not None and stop.is_set():
                log.info("stop requested at step %d", step)
                break
            now = step + 1
            t_iter = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                log.info("data exhausted at step %d", step)
                break
            state, metrics = step_fn(state, batch)
            ctel.observe_step(time.perf_counter() - t_iter,
                              phase="first" if step == start_step else "run")
            if cfg.log_every and now % cfg.log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}  # waits
                dt = max(time.perf_counter() - t0, 1e-9)
                n_window = now - window_started_at
                vals["step_seconds"] = dt / n_window
                vals["steps_per_sec"] = n_window / dt
                if cfg.tokens_per_step:
                    vals.update(ctel.update_throughput(
                        cfg.tokens_per_step * n_window / dt,
                        flops_per_token=cfg.flops_per_token))
                history.append({"step": now, **vals})
                (on_log or _default_log)(now, vals)
                t0 = time.perf_counter()
                window_started_at = now
            if manager is not None:
                manager.save(now, state)
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
