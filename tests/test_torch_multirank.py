"""Multi-rank worlds for the port's parallel tests, on the CPU over gloo.

``run_world(case, world, tmp_path, inputs)`` starts ``world`` processes of
this file, each joining a gloo process group at a ``file://`` rendezvous
under ``tmp_path`` (never a fixed port) and running the function
registered as ``case`` with its rank and the pickled ``inputs``; it
returns what each rank returned.  ``World`` starts them before the
inputs are ready, so their start overlaps the caller's work.  Every
world has a hard time limit and the group's collectives time out after
``GLOO_TIMEOUT``, so a deadlock fails the test instead of hanging the
run.  The cases import torch and the
port only (the tests that call them hold the results against the JAX
package in their own process); this module holds no test of its own.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys
import time
import traceback

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


class World:
    """``world`` processes of this file running ``case``, started before
    their inputs exist: they import torch and join the group while the
    caller computes the inputs, which ``result`` hands over; it returns
    what each rank returned.  Leaving the ``with`` block kills any
    process still running."""

    def __init__(self, name: str, world: int, tmp_path):
        self.dir = pathlib.Path(tmp_path) / f"world-{name}-{world}"
        self.dir.mkdir(parents=True)
        self.world = world
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, name, str(r), str(world),
             str(self.dir)],
            cwd=REPO, env=worker_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def result(self, inputs=None, timeout: float = WORLD_TIMEOUT) -> list:
        staged = self.dir / "inputs.staged"
        torch.save(inputs, staged)
        os.replace(staged, self.dir / "inputs.pt")
        wait_all(self.procs, timeout)
        return [torch.load(self.dir / f"out-{r}.pt", weights_only=False)
                for r in range(self.world)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def run_world(name: str, world: int, tmp_path, inputs=None,
              timeout: float = WORLD_TIMEOUT) -> list:
    with World(name, world, tmp_path) as w:
        return w.result(inputs, timeout)


def _main(name, rank, world, d):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=GLOO_TIMEOUT)
    code = 1
    try:
        deadline = time.monotonic() + WORLD_TIMEOUT
        while not (d / "inputs.pt").exists():
            if time.monotonic() > deadline:
                raise TimeoutError("no inputs")
            time.sleep(0.01)
        inputs = torch.load(d / "inputs.pt", weights_only=False)
        out = CASES[name](rank, world, inputs)
        torch.save(out, d / f"out-{rank}.pt")
        code = 0
    except BaseException:
        traceback.print_exc()
    # Leave without tearing the process groups down: under load, torch's
    # gloo teardown of a world's many groups now and then aborted a rank
    # ("terminate called without an active exception") after its outputs
    # were saved, and nothing a case checks runs past this point.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


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



# -- serving under a mesh ---------------------------------------------------------


def _lockstep(spec: str, world: int):
    """The mesh of ``spec`` over the world (the process's global mesh) and
    its lock-step channel, as ``load_service(mesh_spec=)`` sets them up."""
    from kubeflow_tpu_torch.parallel.context import set_global_mesh
    from kubeflow_tpu_torch.parallel.lockstep import Lockstep
    from kubeflow_tpu_torch.train.run import parse_mesh

    mesh = _mesh(**dataclasses.asdict(parse_mesh(spec, world)))
    set_global_mesh(mesh)
    return mesh, Lockstep()


def _sharded(name, mesh, source, **overrides):
    """This process's shards of ``name`` on the CPU from ``source`` (whole
    tensors, or this process's slices)."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.parallel.sharding import (
        rules_for_model,
        shard_for_serving,
    )

    model = create_model(name, device="meta", **overrides)
    shard_for_serving(model, mesh, rules_for_model(model), device="cpu",
                      source=source)
    return model.eval()


def _jax_llama(tree, mesh, name="llama_debug", **overrides):
    """The reference's params converted whole, cut to this process's
    slices (``params_from_jax(mesh=)``), and a model built on them."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.convert import params_from_jax
    from kubeflow_tpu_torch.parallel.sharding import rules_for_model

    shapes = create_model(name, device="meta", **overrides)
    source = params_from_jax(tree, shapes.cfg, mesh=mesh,
                             rules=rules_for_model(shapes))
    return _sharded(name, mesh, source, **overrides)


def _engine(sched, leader, requests, late=None):
    """One scheduler run in lock step: rank 0 submits every request and
    stops the scheduler after their tokens, a follower follows.
    ``(rank 0's tokens in order or None, tokens by request id as this
    process's bookkeeping completed them, stats after the drain (read
    as the stop begins, before it fails what is left), the ``late``
    request's id and what it raised)``.  ``late`` (rows and a
    budget, paged engine) is submitted third with a deadline that rank
    0 makes pass at its first wait for pages, so it expires after the
    followers saw it picked: it is picked as soon as the second request's
    prefill ends, while the first still holds its pages."""
    from kubeflow_tpu_torch.models.scheduler import PendingRequest

    drained = {}
    fail = sched._fail_outstanding

    def drained_then_fail(exc):
        drained.setdefault("stats", sched.stats())
        fail(exc)

    sched._fail_outstanding = drained_then_fail
    if leader:
        if late is not None:
            begin = sched._begin_prefill

            def expire_at_first_wait(req):
                started = begin(req)
                if not started and req.deadline is not None:
                    req.deadline = time.monotonic()
                return started

            sched._begin_prefill = expire_at_first_wait
        pend = [sched.submit(rows, max_new_tokens=n, temperature=t,
                             top_k=k, seed=seed)
                for rows, n, t, k, seed in requests[:2]]
        if late is not None:
            late = sched.submit(late[0], max_new_tokens=late[1],
                                deadline=time.monotonic() + 3600.0)
        pend += [sched.submit(rows, max_new_tokens=n, temperature=t,
                              top_k=k, seed=seed)
                 for rows, n, t, k, seed in requests[2:]]
        out = [p.result() for p in pend]
        late_seen = None
        if late is not None:
            late.done.wait()
            late_seen = (late.id, type(late.error).__name__)
        sched.stop()
        return out, {p.id: p.outputs for p in pend}, drained["stats"], \
            late_seen
    made = {}
    descriptor = PendingRequest.__dict__["from_spec"]
    build = PendingRequest.from_spec

    def record(spec):
        made[spec["id"]] = req = build(spec)
        return req

    PendingRequest.from_spec = staticmethod(record)
    try:
        sched.follow()
    finally:
        PendingRequest.from_spec = descriptor
    return None, {i: r.outputs for i, r in made.items()}, \
        drained["stats"], sorted(made)


def _service_run(svc, leader, fn):
    """``fn(svc)`` on rank 0, then close; a follower follows until then
    and returns the tokens its own runs of rank 0's requests gave."""
    if not leader:
        seen, generate = [], svc.generate
        svc.generate = lambda **kw: seen.append(generate(**kw))
        svc.follow()
        return seen
    try:
        return fn(svc)
    finally:
        svc.close()


def _local_state(model) -> dict:
    """``{name: tensor}`` of what each parameter of ``model`` stores under
    its own name (a gathered-at-use parameter's shard)."""
    from kubeflow_tpu_torch.parallel.sharding import stored

    out = {}
    for mod_name, mod in model.named_modules():
        if "parametrizations" in mod_name.split("."):
            continue
        names = set(getattr(mod, "parametrizations", {}) or {})
        names |= {n for n, _ in mod.named_parameters(recurse=False)}
        for pname in sorted(names - {"parametrizations"}):
            key = f"{mod_name}.{pname}" if mod_name else pname
            out[key] = stored(mod, pname)
    return out


def _lock_tokens(svc, requests):
    return [svc.generate(rows, max_new_tokens=n, temperature=t, top_k=k,
                         seed=seed) for rows, n, t, k, seed in requests]


def _same_everywhere(*tensors) -> dict:
    """Whether every process holds the same values (gathered bit for bit)."""
    import torch.distributed as dist

    out = []
    for t in tensors:
        t = t.contiguous()
        got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(got, t)
        out.append(all(torch.equal(g, got[0]) for g in got))
    return all(out)


@case
def serve_mesh(rank, world, inp):
    """Llama (and with ``inp["t5"]`` T5) served under ``inp["mesh"]``:
    the lock path from the reference's params (greedy and seeded), the
    decode of every rank bit-equal, beam search, the fixed-slot pool and
    the paged engine (pipelined and synchronous, with ``num_pages``),
    and with ``inp["debug"]`` the spec-decode-mesh fallback and
    /debug/serve.  Every engine runs rank 0's requests in lock step."""
    from kubeflow_tpu_torch.models import generate as tgen
    from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
    from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
    from kubeflow_tpu_torch.models.serve import GenerationService, create_app

    mesh, ls = _lockstep(inp["mesh"], world)
    leader = ls.leader
    model = _jax_llama(inp["llama"], mesh, max_seq_len=64)
    out = {"kv_heads": model.local_kv_heads()}
    reqs = inp["requests"]
    out["lock"] = _service_run(
        GenerationService(model, mesh=mesh, lockstep=ls), leader,
        lambda svc: _lock_tokens(svc, reqs))
    # Every rank runs the same decode (no service): bit-equal tokens.
    prompt = torch.tensor([[5, 9, 2, 7], [3, 1, 4, 0]])
    mask = torch.tensor([[True] * 4, [True] * 3 + [False]])
    with torch.inference_mode():
        seeded = tgen.generate(model, prompt, prompt_mask=mask,
                               max_new_tokens=6, temperature=0.9, top_k=5,
                               generators=tgen.row_generators(7, 2, "cpu"))
        beams = tgen.beam_search(model, prompt[:1], max_new_tokens=4,
                                 beams=2)
    out["seeded"] = seeded.tolist()
    out["beam"] = beams.tolist()
    out["same_everywhere"] = _same_everywhere(seeded, beams)
    knobs = dict(slots=4, slot_len=64, quantum=3)
    sched = DecodeScheduler(model, mesh=mesh, lockstep=ls, **knobs)
    out["fixed"], out["fixed_by_id"], out["fixed_stats"], _ = _engine(
        sched, leader, reqs)
    out["fixed_rows"] = (sched._lo, sched._hi)
    paged = {}
    for pipeline in (True, False):
        sched = PagedDecodeScheduler(
            model, mesh=mesh, lockstep=ls, page_len=8,
            num_pages=inp["num_pages"], pipeline=pipeline, **knobs)
        pages = set()
        allocate = sched.allocator.alloc

        def alloc(n):
            got = allocate(n)
            pages.update(got or ())
            return got

        sched.allocator.alloc = alloc
        toks, by_id, st, late = _engine(
            sched, leader, reqs + inp["prefix_requests"], inp["late"])
        paged[pipeline] = {"tokens": toks, "by_id": by_id, "stats": st,
                           "late": late,
                           "pool_rows": sched._pool.k[0].shape[0],
                           "max_page": max(pages)}
    out["paged"] = paged
    if inp.get("debug"):
        out["debug"] = {}
        for key, draft in (("fallback", model), ("paged", None)):
            svc = GenerationService(model, mesh=mesh, lockstep=ls,
                                    draft_model=draft)

            def drive(svc):
                app = create_app(svc, model_name="m")
                toks = svc.generate([[5, 9, 2, 7]], max_new_tokens=4)
                get = lambda path: app.handle("GET", path, {}, b"")[2]
                import json
                return {"tokens": toks,
                        "metrics": get("/metrics").decode(),
                        "debug": json.loads(get("/debug/serve")),
                        "fallback": svc.scheduler_fallback}

            got = _service_run(svc, leader, drive)
            out["debug"][key] = got if leader else type(
                svc._scheduler).__name__
    if inp.get("t5"):
        from kubeflow_tpu_torch.models import create_model
        from kubeflow_tpu_torch.models.convert import state_from_flax
        from kubeflow_tpu_torch.models.serve import Seq2SeqGenerationService

        whole = create_model("t5_debug", device="cpu")
        t5 = _sharded("t5_debug", mesh, state_from_flax(
            {"params": inp["t5"]}, whole))
        del whole
        out["t5"] = _service_run(
            Seq2SeqGenerationService(t5, mesh=mesh, lockstep=ls), leader,
            lambda svc: svc.generate([[5, 9, 2, 7]], max_new_tokens=5))
    if inp.get("checkpoint"):
        from kubeflow_tpu_torch.models.serve import load_service
        from kubeflow_tpu_torch.parallel.sharding import (
            layout_for,
            llama_rules,
            local_shard,
        )
        from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

        svc = load_service("llama_debug", device="cpu", max_seq_len=64,
                           checkpoint_dir=inp["checkpoint"],
                           mesh_spec=inp["mesh"], use_scheduler=False)
        with CheckpointManager(inp["checkpoint"]) as mgr:
            saved = mgr.restore_params()
        mine = _local_state(svc.model)
        rules = llama_rules()
        out["slices_equal"] = sorted(mine) == sorted(saved) and all(
            torch.equal(mine[k], local_shard(
                v, layout_for(k, v.shape, rules, mesh), mesh).to(
                    mine[k].dtype)) for k, v in saved.items())
        out["sliced"] = sorted(k for k, v in mine.items()
                               if v.shape != saved[k].shape)
        out["checkpoint_tokens"] = _service_run(
            svc, leader, lambda svc: svc.generate([[5, 9, 2]],
                                                  max_new_tokens=4))
    return out


@case
def serve_failure(rank, world, inp):
    """A failure inside lock-step device work.  By default a follower
    whose pool step raises in its second quantum: it leaves the world,
    and rank 0's request must fail, not hang.  With ``inp["leader"]``
    rank 0's model raises in the lock path's first decode step, after the
    request was sent: its request fails, a second one is refused at once,
    and the follower, inside the same decode, must end too.  Returns what
    each rank saw and how long rank 0's request took."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
    from kubeflow_tpu_torch.models.serve import GenerationService
    from kubeflow_tpu_torch.parallel.sharding import (
        llama_rules,
        shard_for_serving,
    )

    mesh, ls = _lockstep("tp=2", world)
    model = create_model("llama_debug", device="meta", max_seq_len=64)
    shard_for_serving(model, mesh, llama_rules(), device="cpu", seed=0)
    model.eval()
    leader_fails = bool(inp and inp.get("leader"))
    if leader_fails:
        svc = GenerationService(model, mesh=mesh, lockstep=ls)
    else:
        sched = DecodeScheduler(model, mesh=mesh, lockstep=ls, slots=2,
                                slot_len=64, quantum=2)
    if ls.leader == leader_fails:
        calls = {"n": 0}

        def failing(fn):
            def call(*a, **k):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError(f"injected failure on rank {rank}")
                return fn(*a, **k)
            return call

        if leader_fails:
            model.forward = failing(model.forward)
        else:
            sched._pool_steps = failing(sched._pool_steps)
    if not ls.leader:
        t0 = time.monotonic()
        try:
            svc.follow() if leader_fails else sched.follow()
        except Exception as e:  # noqa: BLE001 — what the follower saw
            return {"error": repr(e), "seconds": time.monotonic() - t0}
        return {"error": None}
    t0 = time.monotonic()
    out = {}
    for key in ("error", "second") if leader_fails else ("error",):
        try:
            if leader_fails:
                svc.generate([[5, 9, 2, 7]], max_new_tokens=40)
            else:
                sched.submit([[5, 9, 2, 7]], max_new_tokens=40).result()
            out[key] = None
        except Exception as e:  # noqa: BLE001 — what the request saw
            out[key] = repr(e)
        out.setdefault("seconds", time.monotonic() - t0)
    out["broken"] = ls.broken is not None
    if not leader_fails:
        out["alive"] = sched.alive
    return out


@case
def moe_ep(rank, world, inp):
    """Mixtral under ``ep`` = world: one MoE layer on this process's rows
    (output and aux loss), a sharded step's expert gradients (SGD at
    lr 1: the update is the gradient), and served tokens on the lock path
    and the fixed-slot pool."""
    from kubeflow_tpu_torch.models.moe import MoeMlp
    from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
    from kubeflow_tpu_torch.models.serve import GenerationService
    from kubeflow_tpu_torch.parallel.context import global_mesh
    from kubeflow_tpu_torch.parallel.mesh import axis_index
    from kubeflow_tpu_torch.parallel.sharding import llama_rules
    from kubeflow_tpu_torch.parallel.train import (
        make_sharded_train_step,
        shard_train_state,
    )
    from kubeflow_tpu_torch.train.steps import TrainState, make_lm_grad_fn

    mesh, ls = _lockstep(f"ep={world}", world)
    ep = axis_index(mesh, "ep")
    out = {}
    # One layer: the experts this process holds, its own batch row.
    layer = inp["layer"]
    e = layer["w_gate"].shape[0]
    m = MoeMlp(layer["w_gate"].shape[1], layer["w_gate"].shape[2], e,
               top_k=inp["top_k"], capacity_factor=inp["capacity_factor"],
               dtype=torch.float32)
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(layer["router"]))
        for name in ("w_gate", "w_up", "w_down"):
            setattr(m, name, torch.nn.Parameter(torch.from_numpy(
                layer[name]).chunk(world)[ep].clone(), requires_grad=False))
        x = torch.from_numpy(inp["x"][ep:ep + 1])
        mask = torch.from_numpy(inp["mask"][ep:ep + 1])
        with global_mesh(mesh):
            y, aux = m(x, mask)
    out["layer"] = (y.numpy(), float(aux))
    # One sharded step over ep (a data axis: each process its rows).
    from kubeflow_tpu_torch.models import create_model

    model = create_model("mixtral_debug", device="cpu",
                         param_dtype=torch.float32, max_seq_len=64)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inp["mixtral"].items()})
    model.requires_grad_(True)
    rules = llama_rules()
    state = shard_train_state(
        TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0)),
        mesh, rules)
    before = {k: p.detach().clone()
              for k, p in state.module.named_parameters()}
    step, _ = make_sharded_train_step(make_lm_grad_fn(), state, mesh, rules)
    with global_mesh(mesh):
        state, metrics = step(state, _rows(inp["tokens"], mesh))
    out["loss"] = float(metrics["loss"])
    out["expert_grads"] = {
        k: (before[k] - p.detach()).numpy()
        for k, p in state.module.named_parameters()
        if k.endswith(("w_gate", "w_up", "w_down"))}
    # Served tokens.
    served = _sharded("mixtral_debug", mesh,
                      {k: torch.from_numpy(v) for k, v in
                       inp["mixtral"].items()}, max_seq_len=64)
    out["expert_rows"] = served.layers[0].mlp.w_gate.shape[0]
    reqs = inp["requests"]
    out["lock"] = _service_run(
        GenerationService(served, mesh=mesh, lockstep=ls), ls.leader,
        lambda svc: _lock_tokens(svc, reqs))
    sched = DecodeScheduler(served, mesh=mesh, lockstep=ls, slots=2,
                            slot_len=64, quantum=3)
    out["fixed"] = _engine(sched, ls.leader, reqs)[0]
    return out

if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
          pathlib.Path(sys.argv[4]))
