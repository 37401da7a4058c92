"""Multi-process bring-up: join the ``torch.distributed`` process group
from the environment a worker pod carries.

Counterpart of ``kubeflow_tpu/parallel/dist.py``.  The platform injects
its worker env (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``, the
``MEGASCALE_*`` block; ``parallel/envspec.py``); ``process_grid`` turns it
into the rendezvous address, the world size and this process's rank, as
the reference computes them for ``jax.distributed.initialize``.
torchrun's env (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) is PyTorch's form of the discovery ``jax.distributed``
does on its own.

One process drives one GPU.  The platform env names one process a host;
a host with G GPUs runs ``parallel/launch.py``, which reads that env as
its node grid and starts G processes under torchrun's static rendezvous.
Each of them carries both envs, and its own (torchrun's) describes the
world it is in, so ``initialize_from_env`` reads torchrun's first and
the platform's only without it.  ``initialize_from_env`` joins over NCCL
for ``device_type="cuda"`` and over gloo only for ``"cpu"``; it never
moves to the other when one is missing.
"""
from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.parallel import envspec

DEFAULT_COORDINATOR_PORT = envspec.DEFAULT_COORDINATOR_PORT
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# torchrun's variables.
ENV_RANK, ENV_WORLD_SIZE, ENV_LOCAL_RANK = "RANK", "WORLD_SIZE", "LOCAL_RANK"
ENV_MASTER_ADDR, ENV_MASTER_PORT = "MASTER_ADDR", "MASTER_PORT"


def worker_env() -> dict:
    """The platform's worker env of this process (``envspec.worker_env_from``
    over ``os.environ``)."""
    return envspec.worker_env_from(os.environ)


def num_slices() -> int:
    """Slices in this deployment (1 unless the platform spawned
    multislice)."""
    return int(worker_env()["num_slices"] or 1)


def slice_id() -> int:
    """This worker's slice (MEGASCALE_SLICE_ID)."""
    return int(worker_env()["slice_id"] or 0)


def elastic_slices() -> tuple:
    """``(allocated, declared)`` slice counts: the granted width
    (MEGASCALE_NUM_SLICES) and the job's declared one (KFT_SPEC_SLICES);
    equal outside a gang the queue admitted shrunk."""
    env = worker_env()
    allocated = int(env["num_slices"] or 1)
    declared = int(env["spec_slices"] or allocated)
    return allocated, declared


def process_grid(env: Optional[dict] = None, *,
                 coordinator_port: int = DEFAULT_COORDINATOR_PORT
                 ) -> Optional[tuple]:
    """``(coordinator_address, num_processes, process_id)`` from the
    platform's worker env, or None for a single-host deployment; the
    reference's pure function, same tuple from the same env.

    ``TPU_WORKER_ID``/``TPU_WORKER_HOSTNAMES`` are per slice; the global
    id folds in ``MEGASCALE_SLICE_ID`` slice-major, the layout
    ``mesh.make_hybrid_mesh`` assumes.  Multislice without
    ``MEGASCALE_COORDINATOR_ADDRESS`` raises ``RuntimeError`` (every slice
    would dial its own worker 0 and hang)."""
    env = env if env is not None else worker_env()
    if not env["hostnames"]:
        return None
    hosts = [h.strip() for h in env["hostnames"].split(",") if h.strip()]
    slices = int(env["num_slices"] or 1)
    if len(hosts) * slices <= 1:
        return None
    worker_id = int(env["worker_id"] or 0)
    if slices > 1 and not env["coordinator"]:
        raise RuntimeError(
            "MEGASCALE_NUM_SLICES > 1 but MEGASCALE_COORDINATOR_ADDRESS is "
            "unset; multislice needs the global coordinator address")
    coordinator_host = env["coordinator"] or hosts[0]
    sid = int(env["slice_id"] or 0)
    return (f"{coordinator_host}:{coordinator_port}", len(hosts) * slices,
            sid * len(hosts) + worker_id)


def torchrun_grid(environ: Optional[Mapping[str, str]] = None
                  ) -> Optional[tuple]:
    """``(address, world_size, rank, local_rank)`` from torchrun's env, or
    None when ``WORLD_SIZE`` is unset.  A world of 1 is a grid too: the
    caller asked for a process group."""
    environ = os.environ if environ is None else environ
    if not environ.get(ENV_WORLD_SIZE):
        return None
    missing = [k for k in (ENV_RANK, ENV_MASTER_ADDR, ENV_MASTER_PORT)
               if not environ.get(k)]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not")
    return (f"{environ[ENV_MASTER_ADDR]}:{environ[ENV_MASTER_PORT]}",
            int(environ[ENV_WORLD_SIZE]), int(environ[ENV_RANK]),
            int(environ.get(ENV_LOCAL_RANK) or 0))


def initialize_from_env(*, device_type: str = "cuda",
                        coordinator_port: int = DEFAULT_COORDINATOR_PORT,
                        timeout: Optional[datetime.timedelta] = None
                        ) -> bool:
    """Join the deployment's process group: ``init_process_group`` over
    NCCL (``device_type="cuda"``, after ``torch.cuda.set_device(LOCAL_RANK
    or 0)``) or gloo (``"cpu"``), at ``tcp://{coordinator}:{port}`` with
    the grid's world size and rank.  A process a launcher started
    (torchrun's ``WORLD_SIZE`` set) joins the world torchrun's env
    describes, even beside the platform's env; otherwise the platform's is
    read (``process_grid``).  Returns True when it joined, False for a
    single process (no such env, or the platform env of one host).
    Raises when CUDA is asked for without a card."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    run = torchrun_grid()
    if run is not None:
        address, world, rank, local_rank = run
    else:
        grid = process_grid(coordinator_port=coordinator_port)
        if grid is None:
            return False
        address, world, rank = grid
        local_rank = 0
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_from_env(device_type='cuda') but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(local_rank)
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(BACKENDS[device_type],
                            init_method=f"tcp://{address}",
                            world_size=world, rank=rank, **kwargs)
    return True
