"""The port's worker env contract and process-group bring-up
(``kubeflow_tpu_torch/parallel/envspec.py``, ``dist.py``) against the
JAX package's, and joining a world of 2 over gloo from the platform's
env and from torchrun's."""
import socket
import subprocess
import sys
import textwrap

import pytest

from kubeflow_tpu.parallel import dist as jax_dist, envspec as jax_envspec
from kubeflow_tpu_torch.parallel import dist, envspec
from test_torch_multirank import REPO, wait_all, worker_env

GRIDS = {
    "multislice": {"worker_id": "1", "hostnames": "a,b", "num_slices": "3",
                   "slice_id": "2", "coordinator": "coord"},
    "empty": {"hostnames": "", "num_slices": "", "worker_id": "",
              "slice_id": "", "coordinator": ""},
    "no-coordinator": {"worker_id": "0", "hostnames": "a,b",
                       "num_slices": "2", "slice_id": "0",
                       "coordinator": ""},
    "notebook": {"worker_id": "1",
                 "hostnames": "nb-s1-0.nb-workers,nb-s1-1.nb-workers",
                 "num_slices": "2", "slice_id": "1",
                 "coordinator": "nb-0.nb-workers"},
    "one-host": {"worker_id": "0", "hostnames": "a", "num_slices": "",
                 "slice_id": "", "coordinator": ""},
    "one-slice": {"worker_id": "2", "hostnames": "h0, h1,h2,",
                  "num_slices": "1", "slice_id": "", "coordinator": ""},
}


def test_envspec_constants_and_parser_equal_the_reference():
    names = [n for n in dir(jax_envspec) if n.startswith("ENV_")]
    # The port adds one name, the GPUs of a host a launcher reads.
    assert names and names == [n for n in dir(envspec) if n.startswith(
        "ENV_") and n != "ENV_KFT_GPUS_PER_HOST"]
    assert envspec.ENV_KFT_GPUS_PER_HOST == "KFT_GPUS_PER_HOST"
    for n in names + ["DEFAULT_COORDINATOR_PORT"]:
        assert getattr(envspec, n) == getattr(jax_envspec, n), n
    environ = {getattr(envspec, n): f"value-{i}"
               for i, n in enumerate(names)}
    environ["UNRELATED"] = "x"
    assert envspec.worker_env_from(environ) == \
        jax_envspec.worker_env_from(environ)
    assert envspec.worker_env_from({}) == jax_envspec.worker_env_from({})
    assert dist.DEFAULT_COORDINATOR_PORT == jax_dist.DEFAULT_COORDINATOR_PORT


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_process_grid_equals_the_reference(name):
    """The cases of ``tests/test_parallel.py:86-150``: the same tuple, or
    the same error, from the same env."""
    env = GRIDS[name]

    def run(fn):
        try:
            return fn(env, coordinator_port=1234)
        except RuntimeError as e:
            return ("RuntimeError", str(e))

    got, want = run(dist.process_grid), run(jax_dist.process_grid)
    assert got == want
    if name == "multislice":
        assert got == ("coord:1234", 6, 5)


def test_slice_identity_from_the_env(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "4")
    monkeypatch.setenv("MEGASCALE_SLICE_ID", "2")
    monkeypatch.setenv("KFT_SPEC_SLICES", "6")
    for mod in (dist, jax_dist):
        assert (mod.num_slices(), mod.slice_id(), mod.elastic_slices()) == \
            (4, 2, (4, 6))
    monkeypatch.delenv("MEGASCALE_SLICE_ID")
    monkeypatch.delenv("KFT_SPEC_SLICES")
    assert dist.slice_id() == 0 and dist.elastic_slices() == (4, 4)


def test_initialize_from_env_without_a_grid_or_a_card(monkeypatch):
    for var in ("TPU_WORKER_HOSTNAMES", "MEGASCALE_NUM_SLICES",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize_from_env(device_type="cpu") is False
    with pytest.raises(ValueError, match="device_type"):
        dist.initialize_from_env(device_type="tpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK"):
        dist.initialize_from_env(device_type="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    # No card here: CUDA is asked for and refused, never swapped for gloo.
    with pytest.raises(RuntimeError, match="is_available"):
        dist.initialize_from_env(device_type="cuda")


def test_initialize_from_env_prefers_the_launchers_env(monkeypatch):
    """A process a launcher started carries torchrun's env beside the
    platform's host env: it joins torchrun's world (rank 3 of 4 here),
    not the platform's grid of hosts (process 1 of 2)."""
    calls = []
    monkeypatch.setattr(dist.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    platform = {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0,h1"}
    torchrun = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
                "MASTER_ADDR": "h0", "MASTER_PORT": "4321"}
    for k in ("MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in {**platform, **torchrun}.items():
        monkeypatch.setenv(k, v)
    assert dist.initialize_from_env(device_type="cpu", coordinator_port=1)
    for k in torchrun:
        monkeypatch.delenv(k)
    assert dist.initialize_from_env(device_type="cpu", coordinator_port=1)
    assert calls == [
        ("gloo", {"init_method": "tcp://h0:4321", "world_size": 4,
                  "rank": 3}),
        ("gloo", {"init_method": "tcp://h0:1", "world_size": 2,
                  "rank": 1})]
    # The slice identity still comes from the platform's env.
    assert dist.num_slices() == 1 and dist.elastic_slices() == (1, 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


JOIN = textwrap.dedent("""
    import datetime, os, sys
    import torch, torch.distributed as td
    from kubeflow_tpu_torch.parallel import dist
    joined = dist.initialize_from_env(
        device_type="cpu", coordinator_port=int(os.environ["PORT"]),
        timeout=datetime.timedelta(seconds=60))
    t = torch.tensor([float(td.get_rank() + 1)])
    td.all_reduce(t)
    print(joined, td.get_rank(), td.get_world_size(), td.get_backend(),
          float(t))
    td.destroy_process_group()
""")


@pytest.mark.parametrize("source", ["platform", "torchrun"])
def test_initialize_from_env_joins_a_world_of_two(source):
    port = _free_port()
    envs = []
    for rank in range(2):
        env = {"PORT": str(port)}
        if source == "platform":
            env.update(TPU_WORKER_ID=str(rank),
                       TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1")
        else:
            env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        envs.append(env)
    procs = [subprocess.Popen([sys.executable, "-c", JOIN], cwd=REPO,
                              env=worker_env(e), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for e in envs]
    outs = wait_all(procs, timeout=120)
    lines = sorted(o.strip().splitlines()[-1] for o in outs)
    assert lines == ["True 0 2 gloo 3.0", "True 1 2 gloo 3.0"]
