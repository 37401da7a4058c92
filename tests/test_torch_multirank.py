"""Multi-rank worlds for the port's parallel tests, on the CPU over gloo.

``run_world(case, world, tmp_path, inputs)`` starts ``world`` processes of
this file, each joining a gloo process group at a ``file://`` rendezvous
under ``tmp_path`` (never a fixed port) and running the function
registered as ``case`` with its rank and the pickled ``inputs``; it
returns what each rank returned.  Every world has a hard time limit and
the group's collectives time out after ``GLOO_TIMEOUT``, so a deadlock
fails the test instead of hanging the run.  The cases import torch and the
port only (the tests that call them hold the results against the JAX
package in their own process); this module holds no test of its own.
"""
from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
GLOO_TIMEOUT = datetime.timedelta(seconds=60)
WORLD_TIMEOUT = 240.0
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def worker_env(extra=None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    env.update(extra or {})
    return env


def wait_all(procs, timeout: float = WORLD_TIMEOUT) -> list:
    """Wait for every process (killing all at ``timeout``); returns their
    outputs, and raises with them if one failed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate()[0][-3000:] for p in procs]
        raise AssertionError(f"world timed out after {timeout} s:\n"
                             + "\n---\n".join(tails)) from None
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"ranks {bad} failed:\n"
                             + "\n---\n".join(o[-4000:] for o in outs))
    return outs


def run_world(name: str, world: int, tmp_path, inputs=None,
              timeout: float = WORLD_TIMEOUT) -> list:
    d = pathlib.Path(tmp_path) / f"world-{name}-{world}"
    d.mkdir(parents=True)
    torch.save(inputs, d / "inputs.pt")
    procs = [subprocess.Popen(
        [sys.executable, __file__, name, str(r), str(world), str(d)],
        cwd=REPO, env=worker_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    wait_all(procs, timeout)
    return [torch.load(d / f"out-{r}.pt", weights_only=False)
            for r in range(world)]


def _main(name, rank, world, d):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=GLOO_TIMEOUT)
    try:
        inputs = torch.load(d / "inputs.pt", weights_only=False)
        out = CASES[name](rank, world, inputs)
        torch.save(out, d / f"out-{rank}.pt")
    finally:
        dist.destroy_process_group()


# -- cases ----------------------------------------------------------------------


def _mesh(**axes):
    from kubeflow_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device_type="cpu", **axes)


def _full(state) -> dict:
    """Every parameter of a sharded state whole, f32 numpy."""
    return {name: state.gather(name, p.detach()).float().numpy().copy()
            for name, p in state.module.named_parameters()}


def _llama(state_dict, **overrides):
    from kubeflow_tpu_torch.models import create_model

    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32, **overrides)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    return model.requires_grad_(True)


def _rows(x: np.ndarray, mesh) -> torch.Tensor:
    from kubeflow_tpu_torch.parallel.sharding import data_coordinates

    index, count = data_coordinates(mesh)
    n = x.shape[0] // count
    return torch.from_numpy(x[index * n:(index + 1) * n])


@case
def sharded_steps(rank, world, inp):
    """One sharded LM step per run ``(key, mesh axes, options)``: the
    global loss and the whole updated parameters.  Options: the step's
    keywords, ``n_accum``, ``impl`` (the model's attention route) with
    ``shard_sequence``, and ``segments`` (a packed batch)."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.parallel.context import global_mesh
    from kubeflow_tpu_torch.parallel.sharding import (
        bert_rules,
        infer_state_shardings,
        llama_rules,
        t5_rules,
    )
    from kubeflow_tpu_torch.parallel.train import (
        make_sharded_train_step,
        shard_train_state,
    )
    from kubeflow_tpu_torch.train.steps import TrainState, make_lm_grad_fn

    results = {}
    for key, axes, opts in inp["runs"]:
        kw = dict(opts)
        n_accum = kw.pop("n_accum", 1)
        shard_sequence = kw.pop("shard_sequence", False)
        segments = kw.pop("segments", False)
        overrides = dict(inp.get("overrides", {}))
        if "impl" in kw:
            overrides["impl"] = kw.pop("impl")
        mesh = _mesh(**axes)
        model = _llama(inp["params"], **overrides)
        state = TrainState(model, torch.optim.AdamW(
            model.parameters(), lr=1e-3, betas=(0.9, 0.999),
            eps=inp["eps"], weight_decay=1e-4))
        rules = llama_rules()
        with global_mesh(mesh):
            state = shard_train_state(state, mesh, rules)
            sstep, sh = make_sharded_train_step(
                make_lm_grad_fn(**kw), state, mesh, rules, n_accum=n_accum,
                shard_sequence=shard_sequence)
            batch = _rows(inp["tokens"], mesh)
            if segments:
                batch = (batch, _rows(inp["segment_ids"], mesh))
            state, metrics = sstep(state, batch)
        results[key] = {"loss": float(metrics["loss"]),
                        "params": _full(state),
                        "batch": (sh.index, sh.count)}
    # The rules place every family on fsdp=2 x tp=2 (divisibility).
    mesh = _mesh(fsdp=2, tp=2)
    results["placed"] = {
        name: sum(bool(lay.shards) for lay in infer_state_shardings(
            create_model(name, device="cpu"), mesh, rules()).values())
        for name, rules in (("t5_debug", t5_rules), ("bert_debug",
                                                     bert_rules))}
    return results


def _seq_chunk(x: np.ndarray, index: int, count: int, rows=None):
    n = x.shape[1] // count
    t = torch.from_numpy(x[:, index * n:(index + 1) * n])
    return t if rows is None else t[rows]


def _attention_grads(fn, q, k, v):
    """``(out, dq, dk, dv)`` of ``sum(out ** 2)`` over this process's
    chunk; the gradients of k and v cover every process's queries."""
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    dq, dk, dv = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    return [t.detach().numpy() for t in (out, dq, dk, dv)]


@case
def sequence_parallel(rank, world, inp):
    """Ring and Ulysses attention on each case's sequence chunks over sp =
    world: each process's output and gradients."""
    from kubeflow_tpu_torch.parallel.ring import ring_attention
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = _mesh(sp=world)
    out = {}
    for key, c in inp["cases"].items():
        q, k, v = (_seq_chunk(c[n], rank, world) for n in "qkv")
        kw = dict(mesh=mesh, causal=c["causal"])
        if c["impl"] == "ring":
            fn = lambda q, k, v: ring_attention(
                q, k, v, block_impl=c.get("block_impl", "auto"), **kw)
        else:
            fn = lambda q, k, v: ulysses_attention(q, k, v, **kw)
        out[key] = _attention_grads(fn, q, k, v)
    try:
        q = torch.zeros(2, 16 // world, world + 1, 8)
        ulysses_attention(q, q, q, mesh=mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@case
def sequence_parallel_meshes(rank, world, inp):
    """Ulysses beside a tp axis (tp=2, sp=2), and llama_debug with
    impl="ring" and "ulysses" at dp=2, sp=2: each process's chunk."""
    from kubeflow_tpu_torch.parallel.context import global_mesh
    from kubeflow_tpu_torch.parallel.mesh import axis_index
    from kubeflow_tpu_torch.parallel.ulysses import ulysses_attention

    out = {}
    mesh = _mesh(tp=2, sp=2)
    sp = axis_index(mesh, "sp")
    q = _seq_chunk(inp["q_tp"], sp, 2)
    out["tp"] = ulysses_attention(q, q, q, mesh=mesh,
                                  causal=True).numpy()
    mesh = _mesh(dp=2, sp=2)
    dp, sp = axis_index(mesh, "dp"), axis_index(mesh, "sp")
    tokens = _seq_chunk(inp["tokens"], sp, 2, rows=slice(dp, dp + 1))
    for impl in ("ring", "ulysses"):
        model = _llama(inp["params"], impl=impl)
        with torch.no_grad(), global_mesh(mesh):
            out[impl] = model(tokens).numpy()
    out["coords"] = (dp, sp)
    return out


@case
def tp_decode(rank, world, inp):
    """One Attention layer over tp = world, each process holding its heads'
    rows of q/k/v, o_proj's matching columns and its heads of the cache: a
    dense-cache prefill, then a per-row decode step (``cache_slots``).
    Returns both outputs, and the whole layer's on the same inputs."""
    import copy

    from kubeflow_tpu_torch.models.layers import Attention, KVCache
    from kubeflow_tpu_torch.parallel.context import global_mesh
    from kubeflow_tpu_torch.parallel.mesh import axis_index

    mesh = _mesh(tp=world)
    tp = axis_index(mesh, "tp")
    b, s, length, kvh, hd = 2, 5, 8, 2, 16
    whole = Attention(64, 4, kvh, hd, rope_theta=10000.0,
                      dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for lin in (whole.q_proj, whole.k_proj, whole.v_proj, whole.o_proj):
        lin.reset_parameters(gen)
    part = copy.deepcopy(whole)
    for name, dim in (("q_proj", 0), ("k_proj", 0), ("v_proj", 0),
                      ("o_proj", 1)):
        lin = getattr(part, name)
        lin.weight = torch.nn.Parameter(
            lin.weight.detach().chunk(world, dim=dim)[tp].clone(),
            requires_grad=False)
    x = torch.from_numpy(inp["x"])
    x1 = torch.from_numpy(inp["x1"])
    slots = torch.tensor([s, s - 2])
    bias = torch.where(torch.arange(length)[None] <= slots[:, None], 0.0,
                       -1e30)
    out = {}
    for key, attn, heads in (("whole", whole, kvh),
                             ("tp", part, kvh // world)):
        cache = KVCache.empty(1, b, length, heads, hd, dtype=torch.float32,
                              device="cpu")
        with torch.no_grad(), global_mesh(mesh):
            prefill = attn(x, torch.arange(s)[None].expand(b, s),
                           cache=cache)
            decode = attn(x1, slots[:, None], cache=cache, bias_rows=bias,
                          cache_slots=slots)
        out[key] = (prefill.numpy(), decode.numpy())
    return out


def _mlp_stage(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


@case
def pipelines(rank, world, inp):
    """pipeline_apply over pp = world for each case: the output, and with
    ``grad`` the gradients of mean(y^2) summed over the stages; then the
    reference's rejections."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = _mesh(pp=world)
    out = {}
    for key, c in inp["cases"].items():
        params = {k: torch.from_numpy(v).requires_grad_(c["grad"])
                  for k, v in c["params"].items()}
        x = torch.from_numpy(c["x"])
        y = pipeline_apply(_mlp_stage, params, x, mesh=mesh,
                           n_micro=c["n_micro"],
                           interleave=c.get("interleave", 1))
        res = {"y": y.detach().numpy()}
        if c["grad"]:
            grads = torch.autograd.grad((y ** 2).mean(),
                                        list(params.values()))
            for name, g in zip(params, grads):
                g = g.contiguous()
                dist.all_reduce(g)
                res["d" + name] = g.numpy()
        out[key] = res
    errors = {}
    stacked = {k: torch.from_numpy(v)
               for k, v in inp["cases"]["gpipe"]["params"].items()}
    x = torch.zeros(8, stacked["w1"].shape[1])
    for key, kw in (("n_micro", dict(params=stacked, n_micro=world + 2,
                                     interleave=2)),
                    ("leading", dict(params={"w": torch.zeros(world + 1,
                                                               4, 4)},
                                     n_micro=2))):
        try:
            pipeline_apply(lambda p, x: x, kw.pop("params"), x, mesh=mesh,
                           **kw)
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    return out


@case
def pipeline_tp(rank, world, inp):
    """The interleaved schedule over pp=2 with stages split Megatron-style
    over tp=2: each process passes its tp shards and the stage sums its
    partial product over tp itself."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.mesh import axis_index
    from kubeflow_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = _mesh(pp=2, tp=2)
    tp, group = axis_index(mesh, "tp"), mesh.get_group("tp")
    p = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    local = {"w1": p["w1"].chunk(2, dim=2)[tp], "b1": p["b1"].chunk(2, 1)[tp],
             "w2": p["w2"].chunk(2, dim=1)[tp], "b2": p["b2"]}

    def tp_stage(params, x):
        h = torch.tanh(x @ params["w1"] + params["b1"])
        y = (h @ params["w2"]).contiguous()
        dist.all_reduce(y, group=group)
        return y + params["b2"]

    y = pipeline_apply(tp_stage, local, torch.from_numpy(inp["x"]),
                       mesh=mesh, n_micro=2, interleave=2)
    return y.numpy()


@case
def checkpoints(rank, world, inp):
    """fsdp=2: restore the one-process checkpoint ``dir_b`` into the mesh
    and report its whole state; train one more step and save it to
    ``dir_a`` through the CheckpointManager; report the whole state."""
    from kubeflow_tpu_torch.parallel.context import global_mesh
    from kubeflow_tpu_torch.parallel.sharding import llama_rules
    from kubeflow_tpu_torch.parallel.train import (
        make_sharded_train_step,
        shard_train_state,
    )
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.train.steps import (
        TrainState,
        adamw,
        make_lm_grad_fn,
    )

    mesh = _mesh(fsdp=2)
    model = _llama(inp["params"])
    rules = llama_rules()
    state = shard_train_state(
        TrainState(model, adamw(model.parameters(), 1e-3)), mesh, rules)
    step, _ = make_sharded_train_step(make_lm_grad_fn(), state, mesh,
                                      rules)
    with CheckpointManager(inp["dir_b"]) as mgr:
        assert mgr.restore(state) is not None
    restored = state.full_state() + (state.step,)
    with global_mesh(mesh):
        state, _ = step(state, _rows(inp["tokens"], mesh))
    with CheckpointManager(inp["dir_a"]) as mgr:
        assert mgr.save(state.step, state)
    return {"restored": restored, "saved": state.full_state() + (state.step,)}


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
          pathlib.Path(sys.argv[4]))
