"""One process a GPU of a pod: run a command on every GPU of this host,
joined with the other hosts of the deployment.

    python -m kubeflow_tpu_torch.parallel.launch [--device cuda|cpu] \\
        [--master-port PORT] -- <command ...>

The GPU form of what libtpu does inside one TPU process, which sees every
chip of its host.  The platform's env names one process a host
(``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``, the ``MEGASCALE_*`` block)
and the GPUs of a host (``KFT_GPUS_PER_HOST``, G); ``launch_grid`` turns
it into a static grid of nodes, and the launcher starts G copies of the
command itself (the command names its own interpreter), each with
torchrun's env names (``worker_envs``).  The node rank is ``slice_id * H
+ worker_id``, the reference's slice-major order, so the global rank
``node_rank * G + local_rank`` keeps the layout ``mesh.make_hybrid_mesh``
assumes.  Each process then joins from that env
(``dist.initialize_from_env``).

On ``--device cuda`` (the default) a host with fewer GPUs than G stops
the launcher; it never runs fewer processes.  ``--device cpu`` runs the
processes without a card, over gloo, for tests.  A process that fails
ends the others and the launcher with a non-zero code.

SIGTERM to the launcher (a preempted pod) is passed to each process:
each trainer agrees with the others on the step to stop at and saves its
checkpoint there (``train/run.py``).  The processes have
``SHUTDOWN_TIMEOUT_S`` from the signal before the launcher kills them;
torchrun's agent would kill them after 30 s, less than a checkpoint of a
model at full width takes to write, and torchrun of torch 2.11 has no
option to lengthen it.  The pod's grace period must cover the
launcher's.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Mapping, Optional

from kubeflow_tpu_torch.parallel import envspec
from kubeflow_tpu_torch.platform import config

LOCALHOST = "127.0.0.1"
# Seconds from a SIGTERM to the launcher until it kills the processes
# still running: a checkpoint of llama_1b4 took 36.8 s to snapshot and
# write on one H100 (PERF.md).
SHUTDOWN_TIMEOUT_S = 120


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


def worker_envs(grid: tuple) -> list:
    """The env of each process of this host, local rank 0 first, for
    ``grid`` (``launch_grid``'s tuple, its port set): torchrun's names,
    the global rank ``node_rank * nproc + local_rank``.  Process 0 of the
    world serves the rendezvous at ``MASTER_ADDR:MASTER_PORT``."""
    addr, port, nnodes, node_rank, nproc = grid
    return [{"MASTER_ADDR": addr, "MASTER_PORT": str(port),
             "WORLD_SIZE": str(nnodes * nproc),
             "RANK": str(node_rank * nproc + local),
             "LOCAL_RANK": str(local)} for local in range(nproc)]


def supervise(command: list, envs: list, *,
              grace_s: float = SHUTDOWN_TIMEOUT_S) -> int:
    """Run ``command`` once for each env of ``envs`` (over this process's
    own) and wait for them; 0 when every process exits 0, else 1.

    A SIGTERM to this process goes to each process, once; those still
    running ``grace_s`` after it are killed.  A process that fails leaves
    a world that can neither step nor save, so the others are killed at
    once.  No process outlives this call."""
    stop_at = []

    def on_sigterm(signum, frame):
        if not stop_at:
            stop_at.append(time.monotonic())

    previous = signal.signal(signal.SIGTERM, on_sigterm)
    procs = []
    try:
        for env in envs:
            # kft: disable=R005 full-environ handoff to the child
            procs.append(subprocess.Popen(command, env={**os.environ,
                                                        **env}))
        forwarded = False
        while True:
            codes = [p.poll() for p in procs]
            failed = [(rank, code) for rank, code in enumerate(codes)
                      if code not in (None, 0)]
            if failed:
                print(f"launch: local rank {failed[0][0]} exited with code "
                      f"{failed[0][1]}; killing the others", file=sys.stderr,
                      flush=True)
                return 1
            if all(code == 0 for code in codes):
                return 0
            if stop_at and not forwarded:
                for p in procs:
                    if p.poll() is None:
                        p.send_signal(signal.SIGTERM)
                forwarded = True
            if stop_at and time.monotonic() - stop_at[0] > grace_s:
                running = [rank for rank, code in enumerate(codes)
                           if code is None]
                print(f"launch: local ranks {running} still running "
                      f"{grace_s:g} s after SIGTERM; killing them",
                      file=sys.stderr, flush=True)
                return 1
            time.sleep(0.1)
    finally:
        signal.signal(signal.SIGTERM, previous)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


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
        nproc = gpus_per_host(os.environ)  # kft: disable=R005 full-environ handoff
    except ValueError as e:
        ap.error(str(e))
    if args.device == "cuda":
        import torch

        found = torch.cuda.device_count()
        if found < nproc:
            ap.error(f"{envspec.ENV_KFT_GPUS_PER_HOST}={nproc} but this "
                     f"host has {found} CUDA device(s)")
    # kft: disable=R005 full-environ handoff to discovery
    grid = launch_grid(envspec.worker_env_from(os.environ), nproc,
                       port=args.master_port)
    if grid[1] is None:
        grid = grid[:1] + (_free_port(),) + grid[2:]
    envs = worker_envs(grid)
    if nproc > 1 and config.knob(
            "OMP_NUM_THREADS", None,
            doc="threads a process; the launcher sets 1 for G > 1 "
                "processes a host when it is unset") is None:
        # As torchrun does: G processes of one host share its cores.
        for env in envs:
            env["OMP_NUM_THREADS"] = "1"
    return supervise(command, envs)


if __name__ == "__main__":
    sys.exit(main())
