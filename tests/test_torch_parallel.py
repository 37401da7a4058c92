"""The port's meshes, partition rules, sharded train step, sharded
checkpoints, per-process data and ``train.run --distributed``
(``kubeflow_tpu_torch/parallel/``) against the JAX package's, on the CPU:
pure layouts and rules in this process, steps over gloo worlds of 2-4
processes (``tests/test_torch_multirank.py``)."""
import dataclasses
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.data import loader as jax_loader
from kubeflow_tpu.models import create_model as jax_create
from kubeflow_tpu.parallel import mesh as jax_mesh, sharding as jax_sharding
from kubeflow_tpu.train import create_train_state, make_lm_train_step as jax_step
from kubeflow_tpu_torch.data import loader
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import (
    _convert,
    _flax_key,
    _target,
    params_from_jax,
)
from kubeflow_tpu_torch.models.llama import CONFIGS
from kubeflow_tpu_torch.parallel import context, mesh, sharding
from kubeflow_tpu_torch.train import checkpoint as ckpt
from kubeflow_tpu_torch.train.steps import (
    TrainState,
    adamw,
    make_grad_accum_step,
    make_lm_grad_fn,
    make_lm_train_step,
)
from test_torch_multirank import REPO, run_world, wait_all, worker_env

LOSS_TOL, PARAM_TOL = 1e-4, 1e-5
DEBUG = dict(n_heads=4, n_kv_heads=4, dim=64, vocab_size=128)


# -- meshes -------------------------------------------------------------------


def _ids(jax_mesh_obj) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jax_mesh_obj.devices)


@pytest.mark.parametrize("axes", [dict(dp=2, fsdp=2, tp=2),
                                  dict(fsdp=-1, tp=2), dict(pp=2, sp=4),
                                  dict(dp=-1)], ids=str)
def test_mesh_layout_equals_the_reference(devices8, axes):
    want = jax_mesh.make_mesh(devices=devices8, **axes)
    got = mesh.mesh_ranks(mesh.resolve_config(None, 8, **axes), 8)
    np.testing.assert_array_equal(got.numpy(), _ids(want))
    assert mesh.AXIS_NAMES == tuple(want.axis_names)


@pytest.mark.parametrize("axes", [dict(dp=3), dict(dp=-1, tp=-1),
                                  dict(fsdp=-1, tp=3)], ids=str)
def test_mesh_errors_equal_the_reference(devices8, axes):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(devices=devices8, **axes)
    with pytest.raises(ValueError) as got:
        mesh.resolve_config(None, 8, **axes)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not both"):
        mesh.resolve_config(mesh.MeshConfig(), 8, dp=2)


@pytest.mark.parametrize("ici,dcn", [
    (dict(fsdp=2, tp=2), dict(dp=2)), (dict(fsdp=4), dict(dp=2)),
    (dict(tp=2), dict(pp=2, dp=2))], ids=str)
def test_hybrid_layout_equals_the_reference(devices8, ici, dcn):
    want = jax_mesh.make_hybrid_mesh(jax_mesh.MeshConfig(**ici),
                                     jax_mesh.MeshConfig(**dcn),
                                     devices=devices8)
    got = mesh.hybrid_mesh_ranks(mesh.MeshConfig(**ici),
                                 mesh.MeshConfig(**dcn), 8)
    np.testing.assert_array_equal(got.numpy(), _ids(want))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        mesh.hybrid_mesh_ranks(mesh.MeshConfig(fsdp=8),
                               mesh.MeshConfig(dp=2), 8)


@pytest.mark.parametrize("n", range(1, 17))
def test_default_mesh_config_equals_the_reference(n):
    assert dataclasses.astuple(mesh.default_mesh_config(n)) == \
        dataclasses.astuple(jax_mesh.default_mesh_config(n))


def test_make_mesh_checks_sizes_then_needs_a_process_group():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh.make_mesh(dp=2, device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(device_type="cpu")


# -- partition rules ------------------------------------------------------------


def _port_dims(path: str, ndim: int) -> list:
    """Reference dimension -> port dimension, by ``models/convert.py``'s
    layout changes."""
    if not path.endswith("/kernel"):
        return list(range(ndim))
    if ndim == 4:                                  # HWIO -> OIHW
        return [2, 3, 1, 0]
    if ndim == 3 and path.endswith("o_proj/kernel"):   # (H, hd, D)
        return [1, 1, 0]
    if ndim == 3:                                  # (D, H, hd)
        return [1, 0, 0]
    return [1, 0]


def _expected_port_spec(path, ref_spec, ndim):
    port_ndim = np.asarray(_convert(path, np.zeros([2] * ndim))).ndim
    spec = [None] * port_ndim
    for dim, axis in zip(_port_dims(path, ndim), ref_spec):
        if axis is not None:
            assert spec[dim] in (None, axis)
            spec[dim] = axis
    return tuple(spec)


FAMILIES = {
    "llama_debug": (lambda: (jnp.ones((1, 8), jnp.int32),), {}, _target),
    "mixtral_debug": (lambda: (jnp.ones((1, 8), jnp.int32),), {}, _target),
    "vit_debug": (lambda: (jnp.ones((1, 32, 32, 3)),), {"train": False},
                  _flax_key),
    "bert_debug": (lambda: (jnp.ones((1, 8), jnp.int32),), {"train": False},
                   _flax_key),
    "t5_debug": (lambda: (jnp.ones((1, 8), jnp.int32),
                          jnp.ones((1, 4), jnp.int32)), {}, _flax_key),
    "resnet_tiny": (lambda: (jnp.ones((1, 32, 32, 3)),), {"train": False},
                    _flax_key),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_every_parameter_shards_like_the_reference(name):
    """Each port parameter's spec names the mesh axis the reference's spec
    names for the same logical dimension (q_proj's heads on tp, its input
    on fsdp, ...), through ``models/convert.py``'s name map."""
    inputs, kwargs, to_port = FAMILIES[name]
    jm = jax_create(name)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *inputs(),
                                            **kwargs))["params"]
    ref_rules = jax_sharding.rules_for_model(jm)
    model = create_model(name, device="meta")
    rules = sharding.rules_for_model(model)
    params = dict(model.named_parameters())
    seen = set()
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for path_keys, leaf in flat:
        path = "/".join(str(k.key) for k in path_keys)
        ref_spec = tuple(jax_sharding.spec_for_leaf(path, ref_rules,
                                                    leaf.ndim))
        key = to_port(path)
        assert key in params, (path, key)
        seen.add(key)
        got = sharding.spec_for_param(key, rules, params[key].ndim)
        assert got == _expected_port_spec(path, ref_spec, leaf.ndim), (
            path, key, got, ref_spec)
    assert seen == set(params)


def test_rules_for_an_unknown_family_raise():
    with pytest.raises(ValueError, match="no partition rules"):
        sharding.rules_for_model(torch.nn.Linear(2, 2))


# -- the sharded step -------------------------------------------------------------


def _setup():
    """The reference's ``_parity_setup`` (``tests/test_parallel.py``):
    llama_debug at 4 heads of 16, vocab 128, f32; tokens [4, 32]."""
    model = jax_create("llama_debug", n_heads=4, n_kv_heads=4, dim=64,
                       vocab_size=128)
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (4, 32), 0,
                                           128))
    state = create_train_state(jax.random.key(0), model, tokens,
                               optax.adamw(1e-3))
    cfg = dataclasses.replace(CONFIGS["llama_debug"], **DEBUG)
    params = {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(state.params), cfg, param_dtype=torch.float32).items()}
    return state, tokens, params


def _segments():
    seg = np.zeros((4, 32), np.int32)
    seg[0, :30] = 1                   # rank 0 of dp: many valid targets
    seg[1, :8], seg[1, 8:20] = 1, 2
    seg[2, :5] = 1                    # rank 1: few (mostly pad)
    seg[3, :12], seg[3, 12:14], seg[3, 14:] = 1, 2, 3
    return seg


def _optimizer(params):
    """AdamW at lr 1e-3 with eps 1e-6 for the parameter comparison: at
    optax's eps 1e-8 the first update lr * g / (|g| + eps) of an element
    whose gradient is near 1e-8 swings with f32 summation-order noise of
    1e-9 in g (3.7e-5 on one up_proj element between fsdp2-tp2 and one
    process); at 1e-6 the update is a smooth function of the gradient
    everywhere, so 1e-5 holds the sharded gradients to the one-process
    ones."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                             weight_decay=1e-4)


def _one_process(params, tokens, *, segments=None, n_accum=1, **kw):
    """The port's one-process step: its loss and updated parameters."""
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32, **DEBUG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    model.requires_grad_(True)
    state = TrainState(model, _optimizer(model.parameters()))
    step = (make_grad_accum_step(make_lm_grad_fn(**kw), n_accum)
            if n_accum > 1 else make_lm_train_step(**kw))
    batch = torch.from_numpy(np.array(tokens))
    if segments is not None:
        batch = (batch, torch.from_numpy(segments))
    state, metrics = step(state, batch)
    return float(metrics["loss"]), {k: p.detach().numpy()
                                    for k, p in model.named_parameters()}


def _fresh_state(params):
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32, **DEBUG)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params.items()})
    return TrainState(model.requires_grad_(True),
                      _optimizer(model.parameters()))


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at each element's magnitude (8 bits of
    significand; the smallest normal's spacing at 0)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


def _per_process_bf16(params, tokens, results, key):
    """The update a mesh makes from bf16 gradients, against an independent
    baseline.  Each data process's rows give its own bf16 gradient, which
    it computed at its tp split (``results``' ``grads``, one process a data
    index); the mesh sums them in f32.  (One process rounds the whole
    batch's gradient once instead, so an element whose rows' terms cancel
    may round elsewhere there; the reference's mesh sums bf16 partial
    gradients too.)  Each process's gradients are held here, element by
    element, to the one-process grad function's bf16 gradients of the
    same rows with the whole model: within one bf16 step of the larger
    magnitude (the tp split sums the f32 terms in another order before
    they are rounded, so a value may round to its neighbour), plus 16 f32
    steps of the tensor's largest magnitude (that order's noise, which
    decides the rounding of an element whose terms cancel).  The update
    returned is made from the world's gradients, as its mesh sums them."""
    grad_fn = make_lm_grad_fn(grad_dtype=torch.bfloat16)
    per = {r[key]["batch"]: r[key]["grads"] for r in results}
    n_data = len(per)
    chunks = np.split(tokens, n_data)
    for (index, count), grads in per.items():
        assert count == n_data
        want, _ = grad_fn(_fresh_state(params),
                          torch.from_numpy(chunks[index].copy()))
        for name, g in grads.items():
            w = want[name].float().numpy()
            # One bf16 step, and the f32 sums' order noise that the
            # rounding carries: 16 f32 steps of the tensor's largest.
            tol = (_bf16_step(np.maximum(np.abs(g), np.abs(w)))
                   + 16 * np.finfo(np.float32).eps * np.abs(w).max())
            worst = (np.abs(g - w) - tol).max()
            assert worst <= 0, (key, index, name, worst)
    state = _fresh_state(params)
    total = None
    for grads in per.values():
        grads = {k: torch.from_numpy(g) / n_data for k, g in grads.items()}
        total = grads if total is None else {
            k: total[k] + g for k, g in grads.items()}
    state.apply_gradients(total)
    return {k: p.detach().numpy() for k, p in state.module.named_parameters()}


RUNS = [
    ("dp2-fsdp2", dict(dp=2, fsdp=2), {}),
    ("fsdp2-tp2", dict(fsdp=2, tp=2), {}),
    ("bf16", dict(fsdp=2, tp=2), {"grad_dtype": torch.bfloat16}),
    ("ce-chunk", dict(dp=2, fsdp=2), {"ce_chunk": 8}),
    ("sp-ring", dict(dp=2, sp=2), {"ce_chunk": 8, "impl": "ring",
                                   "shard_sequence": True}),
    ("packed", dict(dp=2, fsdp=2), {"segments": True}),
    ("accum", dict(fsdp=2, tp=2), {"n_accum": 2}),
]


def test_sharded_step_matches_the_reference_and_one_process(tmp_path):
    """dp=2,fsdp=2 and fsdp=2,tp=2 (and bf16 gradients, the chunked head,
    a sequence split over sp with ring attention, packed rows whose
    processes hold unequal valid counts, 2 accumulated microbatches):
    the global loss within 1e-4 of the reference's one-device step
    (``tests/test_parallel.py:243-258``, ``:385``) and of the port's
    one-process step, the updated parameters within 1e-5 of the port's
    one-process step (bf16 gradients: of each data process's bf16
    gradients of its rows, summed, each held to the one-process grad
    function's on the same rows, ``_per_process_bf16``)."""
    state, tokens, params = _setup()
    seg = _segments()
    results = run_world("sharded_steps", 4, tmp_path, {
        "params": params, "overrides": DEBUG, "tokens": tokens,
        "segment_ids": seg, "eps": 1e-6, "runs": RUNS})
    for key, axes, opts in RUNS:
        opts = dict(opts)
        segments = seg if opts.pop("segments", False) else None
        opts.pop("impl", None), opts.pop("shard_sequence", None)
        jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
               for k, v in opts.items() if k != "n_accum"}
        batch = tokens if segments is None else (tokens, segments)
        if "n_accum" not in opts:
            _, want = jax.jit(jax_step(**jkw))(state, batch)
            got = results[0][key]["loss"]
            assert abs(got - float(want["loss"])) < LOSS_TOL, key
        loss, one = _one_process(params, tokens, segments=segments, **opts)
        if "grad_dtype" in opts:
            bf16 = _per_process_bf16(params, tokens, results, key)
        assert abs(results[0][key]["loss"] - loss) < LOSS_TOL, key
        for r in results:
            assert r[key]["loss"] == results[0][key]["loss"]
            for name, want_p in (bf16 if "grad_dtype" in opts
                                 else one).items():
                assert np.abs(r[key]["params"][name] - want_p).max() \
                    < PARAM_TOL, (key, name)
    assert [r["dp2-fsdp2"]["batch"] for r in results] == [
        (0, 4), (1, 4), (2, 4), (3, 4)]
    assert [r["fsdp2-tp2"]["batch"] for r in results] == [
        (0, 2), (0, 2), (1, 2), (1, 2)]
    assert results[0]["placed"]["t5_debug"] > 0
    assert results[0]["placed"]["bert_debug"] > 0


def test_sharded_step_refuses_a_sequence_split_it_cannot_run():
    """The sequence goes over sp only to a ring or Ulysses model, and such
    a model only gets its chunk (both checked before any exchange)."""
    from kubeflow_tpu_torch.parallel.train import (
        make_sharded_train_step,
        shard_train_state,
    )

    m = _Coords(dict(pp=1, dp=1, fsdp=1, ep=1, tp=1, sp=2),
                dict(pp=0, dp=0, fsdp=0, ep=0, tp=0, sp=0))
    for impl, shard_sequence, match in (
            ("auto", True, "needs an LM step and impl='ring'"),
            ("ring", False, "needs shard_sequence=True")):
        model = create_model("llama_debug", device="cpu", impl=impl,
                             param_dtype=torch.float32)
        state = shard_train_state(
            TrainState(model, adamw(model.parameters(), 1e-3)), m,
            sharding.llama_rules())
        with pytest.raises(ValueError, match=match):
            make_sharded_train_step(make_lm_grad_fn(), state, m,
                                    sharding.llama_rules(),
                                    shard_sequence=shard_sequence)


# -- checkpoints ----------------------------------------------------------------------


def _equal(a, b, where=""):
    """Nested dicts, sequences and tensors equal to the bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_checkpoints_round_trip_between_fsdp2_and_one_process(tmp_path):
    """A one-process checkpoint restores into fsdp=2 bit-equal; the mesh's
    next step saved from fsdp=2 restores bit-equal into one process and
    into ``load_service(checkpoint_dir=)``."""
    from kubeflow_tpu_torch.models.serve import load_service

    params = _llama_params()
    tokens = np.random.default_rng(5).integers(0, 256, (4, 32))
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    model.requires_grad_(True)
    state = TrainState(model, adamw(model.parameters(), 1e-3))
    state, _ = make_lm_train_step()(state, torch.from_numpy(tokens))
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"
    with ckpt.CheckpointManager(str(dir_b)) as mgr:
        mgr.save(state.step, state)
    saved = (model.state_dict(),
             ckpt.optimizer_state_by_name(model, state.optimizer), state.step)
    results = run_world("checkpoints", 2, tmp_path, {
        "params": params, "tokens": tokens, "dir_a": str(dir_a),
        "dir_b": str(dir_b)})
    for r in results:
        _equal(r["restored"][0], dict(saved[0]))
        _equal(r["restored"][1]["state"], saved[1]["state"])
        assert r["restored"][2] == saved[2]
        _equal(r["saved"], results[0]["saved"])
    mesh_params, mesh_optim, mesh_step = results[0]["saved"]
    fresh = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32).requires_grad_(True)
    back = TrainState(fresh, adamw(fresh.parameters(), 1e-3))
    with ckpt.CheckpointManager(str(dir_a)) as mgr:
        assert mgr.latest_step() == 2 and mgr.restore(back) is back
    _equal(fresh.state_dict(), mesh_params)
    _equal(ckpt.optimizer_state_by_name(fresh, back.optimizer)["state"],
           mesh_optim["state"])
    assert back.step == mesh_step == 2
    svc = load_service("llama_debug", checkpoint_dir=str(dir_a),
                       device="cpu")
    _equal(svc.model.state_dict(), mesh_params)


def _llama_params():
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in model.state_dict().items()}


# -- data -----------------------------------------------------------------------------


class _Coords:
    """A mesh's axis sizes and one process's coordinates (the loader reads
    nothing else of a mesh)."""

    mesh_dim_names = mesh.AXIS_NAMES

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, dim):
        return self.sizes[mesh.AXIS_NAMES[dim]]

    def get_local_rank(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("kind", ["tokens", "documents", "images"])
def test_each_process_draws_what_the_reference_process_draws(monkeypatch,
                                                             kind):
    """Over dp=2 x fsdp=2 x tp=2 the data index is dp * 2 + fsdp: process r
    of 4 draws the reference's process r's rows, and processes that differ
    only in tp draw the same."""
    sizes = dict(pp=1, dp=2, fsdp=2, ep=1, tp=2, sp=1)
    for dp in range(2):
        for fsdp in range(2):
            r = dp * 2 + fsdp
            monkeypatch.setattr(jax, "process_index", lambda r=r: r)
            monkeypatch.setattr(jax, "process_count", lambda: 4)
            for tp in range(2):
                m = _Coords(sizes, dict(dp=dp, fsdp=fsdp, tp=tp, ep=0))
                with context.global_mesh(m):
                    if kind == "tokens":
                        got = next(loader.synthetic_lm_batches(
                            global_batch=8, seq_len=16, vocab_size=100,
                            seed=3, start=5))
                        want = next(jax_loader.synthetic_lm_batches(
                            global_batch=8, seq_len=16, vocab_size=100,
                            seed=3, start=5))
                    elif kind == "documents":
                        got = next(loader.synthetic_lm_documents(
                            vocab_size=100, seed=3))
                        want = next(jax_loader.synthetic_lm_documents(
                            vocab_size=100, seed=3))
                    else:
                        got = np.concatenate([a.ravel() for a in next(
                            loader.synthetic_image_batches(
                                global_batch=8, image_size=4, seed=3))])
                        want = np.concatenate([a.ravel() for a in next(
                            jax_loader.synthetic_image_batches(
                                global_batch=8, image_size=4, seed=3))])
                    np.testing.assert_array_equal(got, want)
    m = _Coords(sizes, dict(dp=1, fsdp=1, tp=0, ep=0))
    with context.global_mesh(m), pytest.raises(ValueError,
                                                match="not divisible"):
        loader.synthetic_lm_batches(global_batch=6, seq_len=4, vocab_size=9)


# -- the trainer --------------------------------------------------------------------


TRAIN_ARGV = {
    "lm": ["--model", "llama_debug", "--batch", "4", "--seq", "32"],
    "image": ["--task", "image", "--model", "vit_debug", "--batch", "4",
              "--image-size", "32", "--num-classes", "10", "--lr", "0.1"],
    # The reference's default image model, with batch statistics.
    "resnet": ["--task", "image", "--model", "resnet_tiny", "--batch", "4",
               "--image-size", "16", "--num-classes", "10", "--lr", "0.1"],
}


def _drawn_together(task, args, n):
    """The global batch ``n`` processes draw at step 0: process r's rows
    after process r - 1's."""
    sizes = dict(pp=1, dp=n, fsdp=1, ep=1, tp=1, sp=1)
    parts = []
    for r in range(n):
        with context.global_mesh(_Coords(sizes, dict(dp=r, fsdp=0, ep=0))):
            if task == "lm":
                parts.append((next(loader.synthetic_lm_batches(
                    global_batch=args.batch, seq_len=args.seq,
                    vocab_size=256, seed=args.seed)),))
            else:
                parts.append(next(loader.synthetic_image_batches(
                    global_batch=args.batch, image_size=args.image_size,
                    num_classes=args.num_classes, seed=args.seed)))
    batch = tuple(torch.from_numpy(np.concatenate(x)) for x in zip(*parts))
    return batch[0] if task == "lm" else batch


@pytest.mark.parametrize("task", sorted(TRAIN_ARGV))
def test_train_run_distributed_dp2_on_cpu(tmp_path, task):
    """``train.run --distributed --mesh dp=2 --device cpu`` at world size 2
    (torchrun's env), the LM and the image task (a ViT, and ResNet, whose
    batch statistics are the global batch's): both processes log the
    same global losses, and the first equals the one-process step's loss
    on the batch they drew together."""
    from kubeflow_tpu_torch.train import run as trainer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = TRAIN_ARGV[task] + ["--steps", "2", "--log-every", "1",
                               "--device", "cpu"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.train.run"] + argv
        + ["--distributed", "--mesh", "dp=2"],
        cwd=REPO, env=worker_env(dict(
            RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [o.splitlines() for o in wait_all(procs, timeout=180)]
    losses = []
    for lines in outs:
        assert ("devices=2 mesh={'pp': 1, 'dp': 2, 'fsdp': 1, 'ep': 1, "
                "'tp': 1, 'sp': 1} device=cpu") in lines
        steps = [ln for ln in lines if ln.startswith("train_step ")]
        assert len(steps) == 2 and lines[-1].startswith("done: step 2")
        losses.append([float(ln.split("loss=")[1].split()[0])
                       for ln in steps])
    assert losses[0] == losses[1]
    _, args = trainer.parse_args(argv)
    build = trainer.build_lm if task == "lm" else trainer.build_image
    state, step, _ = build(args, torch.device("cpu"))
    _, metrics = step(state, _drawn_together(task, args, 2))
    assert abs(losses[0][0] - float(metrics["loss"])) < LOSS_TOL
