"""Trainer CLI of the port: build a model, train it on synthetic tokens.

    python -m kubeflow_tpu_torch.train.run --model llama_1b4 --task lm \\
        --steps 6 --batch 1 --seq 8192 --grad-dtype bf16 --log-every 1

The counterpart of the reference trainer (``kubeflow_tpu/train/run.py``,
``--task lm``) on one device: f32 master weights drawn from ``--seed`` on
the device, AdamW as ``optax.adamw``, the LM step of ``train/steps.py``
(attention and RMSNorm on the port's CUDA kernels), the loop of
``train/loop.py``.  Runs on the
card unless ``--device cpu`` is given; without a card it stops with an
error.  ``--checkpoint-dir`` (default ``$KFT_CHECKPOINT_DIR``) resumes
from the latest step there, saves every ``--checkpoint-every`` steps and
on SIGTERM; serve what it wrote with ``python -m
kubeflow_tpu_torch.models.serve --checkpoint-dir``.  ``--task image``, a
``--mesh`` other than ``auto`` and ``--distributed`` are not yet ported
and stop with an error.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Optional

import torch

from kubeflow_tpu_torch import config


def install_preemption_handler(stop: threading.Event,
                               signals=(signal.SIGTERM,)) -> dict:
    """On SIGTERM set ``stop`` so the loop exits between steps.  Returns
    the handlers it replaced (signal -> handler) for the caller to put
    back; installs nothing off the main thread (Python delivers signals
    only there)."""
    if threading.current_thread() is not threading.main_thread():
        return {}

    def _handler(signum, frame):
        stop.set()

    return {sig: signal.signal(sig, _handler) for sig in signals}


def build_lm(args, device: torch.device):
    """``(state, step, batches)`` for the LM task on ``device``."""
    from kubeflow_tpu_torch.data.loader import (
        DeviceLoader,
        synthetic_lm_batches,
        synthetic_lm_documents,
    )
    from kubeflow_tpu_torch.data.packing import packed_lm_batches
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_grad_accum_step,
        make_lm_grad_fn,
        make_lm_train_step,
    )

    model = create_model(args.model, device=device, max_seq_len=args.seq,
                         param_dtype=torch.float32)
    with torch.no_grad():
        model.reset_parameters(
            torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    state = TrainState(model, adamw(model.parameters(), args.lr))
    step_kwargs = {
        "grad_dtype": torch.bfloat16 if args.grad_dtype == "bf16" else None,
        "ce_chunk": args.ce_chunk,
    }
    if args.grad_accum > 1:
        step = make_grad_accum_step(make_lm_grad_fn(**step_kwargs),
                                    args.grad_accum)
    else:
        step = make_lm_train_step(**step_kwargs)
    vocab = model.cfg.vocab_size

    def batches(start_step=0):
        if args.packed:
            # Packed documents: padding-free rows with segment ids (the
            # packer's window is stateful, so this stream is not
            # step-indexed: a resumed run restarts it, as the reference's
            # does).
            max_len = min(256, args.seq)
            return DeviceLoader(packed_lm_batches(
                synthetic_lm_documents(vocab_size=vocab, seed=args.seed,
                                       min_len=min(8, max_len),
                                       max_len=max_len),
                batch_rows=args.batch, seq_len=args.seq), device)
        return DeviceLoader(synthetic_lm_batches(
            global_batch=args.batch, seq_len=args.seq, vocab_size=vocab,
            seed=args.seed, start=start_step), device)

    return state, step, batches


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--model", default="llama_debug")
    ap.add_argument("--task", choices=["lm", "image"], default="lm",
                    help="image is not yet ported")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step "
                         "(the batch must divide evenly)")
    ap.add_argument("--grad-dtype", choices=["f32", "bf16"], default="f32",
                    help="gradient dtype; bf16 = bf16 gradients of a bf16 "
                         "copy of the f32 master weights")
    ap.add_argument("--ce-chunk", type=int, default=None,
                    help="chunked lm_head + cross-entropy chunk size (seq "
                         "must divide by it)")
    ap.add_argument("--packed", action="store_true",
                    help="pack variable-length documents into padding-free "
                         "rows with segment ids")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="auto",
                    help="only 'auto' (one device); others are not yet "
                         "ported")
    # KFT_CHECKPOINT_DIR is what a job controller injects: a restarted
    # worker resumes without its command line naming the directory.
    ap.add_argument("--checkpoint-dir",
                    default=os.environ.get(config.ENV_KFT_CHECKPOINT_DIR)
                    or None,
                    help="resume from and save checkpoints in this "
                         f"directory (default ${config.ENV_KFT_CHECKPOINT_DIR})")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--distributed", action="store_true",
                    help="not yet ported")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unported = {"--task image": args.task == "image",
                "--mesh": args.mesh != "auto",
                "--distributed": args.distributed}
    for flag, given in unported.items():
        if given:
            ap.error(f"{flag} is not yet ported to kubeflow_tpu_torch; see "
                     "ROADMAP.md")
    return ap, args


def train(args, device: torch.device, stop=None):
    """Build the LM task from parsed ``args`` and run the loop on
    ``device``.  Returns ``(state, history)``."""
    from kubeflow_tpu_torch.telemetry import compute as ctel
    from kubeflow_tpu_torch.train.loop import LoopConfig, train_loop

    state, step, batches = build_lm(args, device)
    return train_loop(
        state, step, batches,
        LoopConfig(total_steps=args.steps, log_every=args.log_every,
                   checkpoint_dir=args.checkpoint_dir,
                   checkpoint_every=args.checkpoint_every,
                   tokens_per_step=args.batch * args.seq,
                   flops_per_token=ctel.lm_train_flops_per_token(
                       state.module.cfg, args.seq)),
        stop=stop)


def main(argv: Optional[list] = None) -> int:
    from kubeflow_tpu_torch import resolve_device

    ap, args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    print(f"devices=1 device={device}", flush=True)
    stop = threading.Event()
    replaced = install_preemption_handler(stop)
    try:
        state, history = train(args, device, stop)
    finally:
        for sig, handler in replaced.items():
            signal.signal(sig, handler)
    if stop.is_set():
        print(f"preempted at step {state.step}: checkpoint saved"
              if args.checkpoint_dir else
              f"preempted at step {state.step} (no checkpoint dir)",
              flush=True)
    if history:
        last = history[-1]
        print(f"done: step {last['step']} "
              + " ".join(f"{k}={v:.4g}" for k, v in last.items()
                         if k != "step" and isinstance(v, float)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
