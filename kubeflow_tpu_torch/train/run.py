"""Trainer CLI of the port: build a model, train it on synthetic data.

    python -m kubeflow_tpu_torch.train.run --model llama_1b4 --task lm \\
        --steps 6 --batch 1 --seq 8192 --grad-dtype bf16 --log-every 1
    python -m kubeflow_tpu_torch.train.run --task image --model resnet50 \\
        --batch 256 --image-size 224 --steps 6 --log-every 1

The counterpart of the reference trainer (``kubeflow_tpu/train/run.py``)
on one device, f32 master weights drawn from ``--seed`` on the device and
the loop of ``train/loop.py``.  ``--task lm``: AdamW as ``optax.adamw``
and the LM step of ``train/steps.py`` (attention and RMSNorm on the
port's CUDA kernels).  ``--task image``: a classifier (``resnet*``, whose
batch stats train with it, or ``vit_*``, attention on the kernels) on
synthetic NHWC images of ``--image-size`` and ``--num-classes`` labels,
SGD as ``optax.sgd(lr, momentum=0.9)``, the classification step.  Runs on
the card unless ``--device cpu`` is given; without a card it stops with
an error.  ``--checkpoint-dir`` (default ``$KFT_CHECKPOINT_DIR``) resumes
from the latest step there, saves every ``--checkpoint-every`` steps and
on SIGTERM; serve an LM it wrote with ``python -m
kubeflow_tpu_torch.models.serve --checkpoint-dir``.

``--distributed`` joins the process group from the platform's worker env
or torchrun's (``parallel/dist.py``; NCCL on the card, gloo with
``--device cpu``), one process a device, and ``--mesh`` lays the
reference's axes over the processes:

    torchrun --nproc-per-node 8 -m kubeflow_tpu_torch.train.run \
        --distributed --mesh dp=2,fsdp=2,tp=2 --model llama_1b4 ...

The state is then sharded by the model family's partition rules and
trained by the sharded step (``parallel/train.py``), each process drawing
its rows of the global batch.  A SIGTERM stops every process at the same
step (``parallel/dist.py`` ``AgreedStop``), where they save one
checkpoint.  ``--mesh auto`` factors the process count
(``default_mesh_config``); one process without ``--distributed`` trains
unsharded.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional

import torch

from kubeflow_tpu_torch.parallel.envspec import ENV_KFT_CHECKPOINT_DIR
from kubeflow_tpu_torch.platform import config


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


def mesh_axes(spec: str) -> dict:
    """'tp=4,fsdp=2' -> {"tp": 4, "fsdp": 2} ('auto' -> {}), the
    reference's grammar without a device count; ``ValueError`` on an
    unknown axis or a size that is not an integer."""
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig

    if spec == "auto":
        return {}
    axes = {}
    for part in spec.split(","):
        if not part:
            continue
        key, _, value = part.partition("=")
        if key not in MeshConfig.__dataclass_fields__:
            raise ValueError(f"unknown mesh axis {key!r} in {spec!r}")
        try:
            axes[key] = int(value)
        except ValueError:
            raise ValueError(
                f"mesh axis {key!r} needs an integer, got {value!r}") from None
    return axes


def parse_mesh(spec: str, n_devices: int):
    """'auto' or 'tp=4,fsdp=2' -> the ``MeshConfig`` over ``n_devices``
    processes (the reference's grammar; ``ValueError`` on a bad spec or a
    size that is not the device count)."""
    from kubeflow_tpu_torch.parallel.mesh import (
        default_mesh_config,
        resolve_config,
    )

    axes = mesh_axes(spec)
    if spec == "auto":
        return default_mesh_config(n_devices)
    return resolve_config(None, n_devices, **axes)


def _shard(state, grad_fn, n_accum, mesh, rules):
    """The state placed on ``mesh`` and the sharded step of ``grad_fn``."""
    from kubeflow_tpu_torch.parallel.train import (
        make_sharded_train_step,
        shard_train_state,
    )

    state = shard_train_state(state, mesh, rules)
    step, _ = make_sharded_train_step(grad_fn, state, mesh, rules,
                                      n_accum=n_accum)
    return state, step


def build_lm(args, device: torch.device, mesh=None):
    """``(state, step, batches)`` for the LM task on ``device``, sharded by
    ``llama_rules`` over ``mesh`` when one is given (build and iterate it
    under ``global_mesh(mesh)``, so each process draws its rows)."""
    from kubeflow_tpu_torch.data.loader import (
        DeviceLoader,
        _local_rows,
        synthetic_lm_batches,
        synthetic_lm_documents,
    )
    from kubeflow_tpu_torch.data.packing import packed_lm_batches
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.parallel.sharding import llama_rules
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
    grad_fn = make_lm_grad_fn(**step_kwargs)
    if mesh is not None:
        state, step = _shard(state, grad_fn, args.grad_accum, mesh,
                             llama_rules())
    elif args.grad_accum > 1:
        step = make_grad_accum_step(grad_fn, args.grad_accum)
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
            rows, _ = _local_rows(args.batch)
            return DeviceLoader(packed_lm_batches(
                synthetic_lm_documents(vocab_size=vocab, seed=args.seed,
                                       min_len=min(8, max_len),
                                       max_len=max_len),
                batch_rows=rows, seq_len=args.seq), device)
        return DeviceLoader(synthetic_lm_batches(
            global_batch=args.batch, seq_len=args.seq, vocab_size=vocab,
            seed=args.seed, start=start_step), device)

    return state, step, batches


def build_image(args, device: torch.device, mesh=None):
    """``(state, step, batches)`` for the image task on ``device``: the
    classifier with ``--num-classes`` outputs (a ViT's position table sized
    for ``--image-size``), SGD with momentum 0.9, the classification step
    (through the batch-stats path when the model has them, and per
    microbatch with ``--grad-accum``); over ``mesh`` sharded by
    ``resnet_rules``, as the reference shards every image model."""
    from kubeflow_tpu_torch.data.loader import (
        DeviceLoader,
        synthetic_image_batches,
    )
    from kubeflow_tpu_torch.models import create_model, vit
    from kubeflow_tpu_torch.parallel.sharding import resnet_rules
    from kubeflow_tpu_torch.train.steps import (
        TrainState,
        make_classification_grad_fn,
        make_classification_train_step,
        make_grad_accum_step,
        sgd,
    )

    overrides = {"num_classes": args.num_classes}
    if args.model in vit.CONFIGS:
        overrides["image_size"] = args.image_size
    model = create_model(args.model, device=device, **overrides)
    with torch.no_grad():
        model.reset_parameters(
            torch.Generator(device=device).manual_seed(args.seed))
    model.requires_grad_(True)
    state = TrainState(model, sgd(model.parameters(), args.lr,
                                  momentum=0.9))
    has_stats = bool(state.batch_stats)
    grad_fn = make_classification_grad_fn(has_batch_stats=has_stats)
    if mesh is not None:
        state, step = _shard(state, grad_fn, args.grad_accum, mesh,
                             resnet_rules())
    elif args.grad_accum > 1:
        step = make_grad_accum_step(grad_fn, args.grad_accum,
                                    has_batch_stats=has_stats)
    else:
        step = make_classification_train_step(has_batch_stats=has_stats)

    def batches(start_step=0):
        return DeviceLoader(synthetic_image_batches(
            global_batch=args.batch, image_size=args.image_size,
            num_classes=args.num_classes, seed=args.seed,
            start=start_step), device)

    return state, step, batches


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--model", default="llama_debug")
    ap.add_argument("--task", choices=["lm", "image"], default="lm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches accumulated per optimizer step "
                         "(the batch must divide evenly)")
    ap.add_argument("--grad-dtype", choices=["f32", "bf16"], default="f32",
                    help="lm task: gradient dtype; bf16 = bf16 gradients "
                         "of a bf16 copy of the f32 master weights")
    ap.add_argument("--ce-chunk", type=int, default=None,
                    help="lm task: chunked lm_head + cross-entropy chunk "
                         "size (seq must divide by it)")
    ap.add_argument("--packed", action="store_true",
                    help="pack variable-length documents into padding-free "
                         "rows with segment ids")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="auto",
                    help="'auto' or axis sizes over the processes, e.g. "
                         "dp=2,fsdp=2,tp=2 (axes pp dp fsdp ep tp sp)")
    # KFT_CHECKPOINT_DIR is what a job controller injects: a restarted
    # worker resumes without its command line naming the directory.
    ap.add_argument("--checkpoint-dir",
                    default=config.knob(
                        ENV_KFT_CHECKPOINT_DIR, None,
                        doc="checkpoint dir injected by the GPUJob "
                            "controller") or None,
                    help="resume from and save checkpoints in this "
                         f"directory (default ${ENV_KFT_CHECKPOINT_DIR})")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group from the platform's "
                         "worker env or torchrun's")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.task == "image" and (args.ce_chunk is not None
                                 or args.grad_dtype != "f32"):
        ap.error("--grad-dtype/--ce-chunk apply to the lm task only")
    if args.task == "image":
        from kubeflow_tpu_torch.models import resnet, vit

        if args.model not in {**resnet.CONFIGS, **vit.CONFIGS}:
            ap.error(f"--task image trains a resnet or vit model, not "
                     f"{args.model!r}")
    return ap, args


def train(args, device: torch.device, stop=None, mesh=None):
    """Build the task from parsed ``args`` and run the loop on ``device``,
    sharded over ``mesh`` when one is given (run it under
    ``global_mesh(mesh)``).  Returns ``(state, history)``."""
    from kubeflow_tpu_torch.telemetry import compute as ctel
    from kubeflow_tpu_torch.train.loop import LoopConfig, train_loop

    if args.task == "image":
        state, step, batches = build_image(args, device, mesh)
        throughput = {}
    else:
        state, step, batches = build_lm(args, device, mesh)
        throughput = dict(tokens_per_step=args.batch * args.seq,
                          flops_per_token=ctel.lm_train_flops_per_token(
                              state.module.cfg, args.seq))
    return train_loop(
        state, step, batches,
        LoopConfig(total_steps=args.steps, log_every=args.log_every,
                   checkpoint_dir=args.checkpoint_dir,
                   checkpoint_every=args.checkpoint_every, **throughput),
        stop=stop)


def main(argv: Optional[list] = None) -> int:
    import torch.distributed as dist

    from kubeflow_tpu_torch import resolve_device
    from kubeflow_tpu_torch.parallel import mesh as meshes
    from kubeflow_tpu_torch.parallel.context import global_mesh

    ap, args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    joined = False
    if args.distributed:
        from kubeflow_tpu_torch.parallel.dist import (
            elastic_slices,
            initialize_from_env,
        )

        joined = initialize_from_env(device_type=device.type)
        allocated, declared = elastic_slices()
        if allocated < declared:
            # A gang the queue admitted at fewer slices than it declared:
            # the same checkpoint, a smaller data axis.
            print(f"elastic: running at {allocated}/{declared} slices "
                  "(shrunk; will grow back via checkpoint-restart)",
                  flush=True)
    stop = threading.Event()
    # The loop's stop: this process's SIGTERM alone, or, in a world of
    # more than one process, the world's agreement on it (the same step
    # everywhere).
    check = stop
    replaced = {}
    try:
        n = meshes.world_size()
        try:
            config = parse_mesh(args.mesh, n)
        except ValueError as e:
            ap.error(str(e))   # a clean exit, not a traceback
        mesh = (meshes.make_mesh(config, device_type=device.type)
                if dist.is_initialized() else None)
        shape = dict(zip(meshes.AXIS_NAMES, config.axis_sizes()))
        print(f"devices={n} mesh={shape} device={device}", flush=True)
        if joined and n > 1:
            from kubeflow_tpu_torch.parallel.dist import AgreedStop

            check = AgreedStop(stop)
        replaced = install_preemption_handler(stop)
        with global_mesh(mesh):
            state, history = train(args, device, check, mesh)
    finally:
        for sig, handler in replaced.items():
            signal.signal(sig, handler)
        if joined:
            dist.destroy_process_group()
    if check.stopped if check is not stop else stop.is_set():
        print(f"preempted at step {state.step}: checkpoint saved"
              if args.checkpoint_dir else
              f"preempted at step {state.step} (no checkpoint dir)",
              flush=True)
    if device.type == "cuda":
        from kubeflow_tpu_torch.ops import cuda as kernels

        # What the run launched of the port's kernels (``ops/cuda``).
        print("kernel_launches " + " ".join(
            f"{k}={v}" for k, v in kernels.launch_counts().items()),
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
