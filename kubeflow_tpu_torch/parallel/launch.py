"""One process a GPU of a pod: run a command on every GPU of this host,
joined with the other hosts of the deployment.

    python -m kubeflow_tpu_torch.parallel.launch [--device cuda|cpu] \\
        [--master-port PORT] -- <command ...>

The GPU form of what libtpu does inside one TPU process, which sees every
chip of its host.  The platform's env names one process a host
(``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``, the ``MEGASCALE_*`` block)
and the GPUs of a host (``KFT_GPUS_PER_HOST``, G); ``launch_grid`` turns
it into torchrun's static rendezvous, and ``torch.distributed.run`` starts
G copies of the command (``--no-python``: the command names its own
interpreter).  The node rank is ``slice_id * H + worker_id``, the
reference's slice-major order, so the global rank ``node_rank * G +
local_rank`` keeps the layout ``mesh.make_hybrid_mesh`` assumes.  Each
process then joins from torchrun's env (``dist.initialize_from_env``).

On ``--device cuda`` (the default) a host with fewer GPUs than G stops
the launcher; it never runs fewer processes.  ``--device cpu`` runs the
processes without a card, over gloo, for tests.  A process that fails
ends the launcher with a non-zero code.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import Mapping, Optional

from kubeflow_tpu_torch.parallel import envspec

LOCALHOST = "127.0.0.1"


def launch_grid(env: dict, nproc: int, *,
                port: Optional[int] = None) -> tuple:
    """``(master_addr, master_port, nnodes, node_rank, nproc)`` from the
    platform's worker env ``env`` (``envspec.worker_env_from``'s dict) and
    ``nproc`` processes a host.  The hosts' grid is ``dist.process_grid``'s:
    the coordinator's address, the hosts as nodes, this host's process id
    as its node rank, at ``port`` (default ``DEFAULT_COORDINATOR_PORT``,
    what the coordinator's Service exposes).  A host with no grid is one
    node on this host, at ``port`` or, with None, any free local port (no
    other pod dials it)."""
    from kubeflow_tpu_torch.parallel import dist

    if nproc < 1:
        raise ValueError(f"nproc must be at least 1, got {nproc}")
    grid = dist.process_grid(
        env, coordinator_port=envspec.DEFAULT_COORDINATOR_PORT
        if port is None else port)
    if grid is None:
        return (LOCALHOST, port, 1, 0, nproc)
    address, nnodes, node_rank = grid
    host, _, master_port = address.rpartition(":")
    return (host, int(master_port), nnodes, node_rank, nproc)


def gpus_per_host(environ: Mapping[str, str]) -> int:
    """``KFT_GPUS_PER_HOST`` of ``environ``; raises ``ValueError`` when it
    is unset or not a positive count."""
    raw = environ.get(envspec.ENV_KFT_GPUS_PER_HOST)
    try:
        n = int(raw)
    except (TypeError, ValueError):
        n = 0
    if n < 1:
        raise ValueError(f"{envspec.ENV_KFT_GPUS_PER_HOST}={raw!r}: the "
                         "launcher needs the GPUs of this host (the pod's "
                         "env sets it)")
    return n


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind((LOCALHOST, 0))
        return sock.getsockname()[1]


def torchrun_args(grid: tuple, command: list) -> list:
    """The arguments of ``torch.distributed.run`` for ``grid``
    (``launch_grid``'s tuple, its port set) and ``command``."""
    addr, port, nnodes, node_rank, nproc = grid
    return ["--nnodes", str(nnodes), "--node-rank", str(node_rank),
            "--nproc-per-node", str(nproc), "--master-addr", addr,
            "--master-port", str(port), "--no-python", *command]


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" not in argv:
        own, command = argv, []
    else:
        cut = argv.index("--")
        own, command = argv[:cut], argv[cut + 1:]
    ap = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.parallel.launch",
        description="run a command once for each GPU of this host "
                    "(KFT_GPUS_PER_HOST), joined with the other hosts of "
                    "the platform's worker env; the command follows '--'")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: stop unless the host has the GPUs; cpu: "
                         "no card (tests)")
    ap.add_argument("--master-port", type=int, default=None,
                    help="the rendezvous port of a grid of hosts (default "
                         f"{envspec.DEFAULT_COORDINATOR_PORT}); one host "
                         "takes a free local port")
    args = ap.parse_args(own)
    if not command:
        ap.error("no command: give it after '--'")
    try:
        nproc = gpus_per_host(os.environ)
    except ValueError as e:
        ap.error(str(e))
    if args.device == "cuda":
        import torch

        found = torch.cuda.device_count()
        if found < nproc:
            ap.error(f"{envspec.ENV_KFT_GPUS_PER_HOST}={nproc} but this "
                     f"host has {found} CUDA device(s)")
    grid = launch_grid(envspec.worker_env_from(os.environ), nproc,
                       port=args.master_port)
    if grid[1] is None:
        grid = grid[:1] + (_free_port(),) + grid[2:]
    from torch.distributed import run
    from torch.distributed.elastic.multiprocessing.errors import (
        ChildFailedError,
    )

    try:
        run.main(torchrun_args(grid, command))
    except ChildFailedError as e:
        print(e.format_msg(), file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
