"""Ring and Ulysses attention of the port (``kubeflow_tpu_torch/parallel/``)
against the JAX package's, on the CPU: the same numpy inputs go through
the reference's ``shard_map`` over the conftest's virtual devices and
through the port's processes over gloo (``tests/test_torch_multirank.py``),
each process holding its chunk of the sequence."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS, Llama as JaxLlama
from kubeflow_tpu.ops.attention import xla_attention
from kubeflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kubeflow_tpu.parallel.ring import ring_attention as jax_ring
from kubeflow_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from kubeflow_tpu_torch import ops
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.llama import CONFIGS
from kubeflow_tpu_torch.parallel.ring import (
    DENSE,
    DIAGONAL,
    SKIPPED,
    hop_mode,
    ring_attention,
    use_flash,
)
from test_torch_multirank import run_world

OUT_TOL, GRAD_TOL = 2e-5, 1e-4


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


def _reference(fn, devices, n, q, k, v, causal):
    """The JAX function's output and its gradients of sum(out ** 2)."""
    mesh = jax_make_mesh(sp=n, devices=devices[:n])
    run = lambda q, k, v: fn(q, k, v, mesh=mesh, causal=causal)
    out = jax.jit(run)(q, k, v)
    loss = lambda q, k, v: (run(q, k, v).astype(jnp.float32) ** 2).sum()
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


def _joined(results, key):
    """Each process's (out, dq, dk, dv) chunks joined along the sequence."""
    return [np.concatenate([r[key][i] for r in results], axis=1)
            for i in range(4)]


def _cases():
    cases = {}
    for heads, kvh in (("mha", 4), ("gqa", 2)):
        for causal in (False, True):
            q, k, v = _qkv(len(cases), 2, 64, 4, kvh, 16)
            cases[f"ring-{heads}-{causal}"] = dict(
                impl="ring", causal=causal, q=q, k=k, v=v)
    # The flash block route (the plain version on CPU tensors), d 64.
    q, k, v = _qkv(9, 1, 32, 4, 2, 64)
    cases["ring-flash-True"] = dict(impl="ring", causal=True, q=q, k=k, v=v,
                                    block_impl="flash")
    for kvh in (4, 2):   # kv heads split over sp, or repeated first
        for causal in (False, True):
            q, k, v = _qkv(20 + kvh, 2, 32, 8, kvh, 16)
            cases[f"ulysses-{kvh}-{causal}"] = dict(
                impl="ulysses", causal=causal, q=q, k=k, v=v)
    return cases


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_and_ulysses_match_the_reference(devices8, tmp_path, sp):
    """At sp 2 and 4, causal and not, MHA and GQA: each output within
    2e-5 of the reference's (einsum blocks for the ring), the gradients
    within 1e-4 of ``jax.grad`` of it."""
    cases = _cases()
    results = run_world("sequence_parallel", sp, tmp_path, {"cases": cases})
    for key, c in cases.items():
        fn = jax_ring if c["impl"] == "ring" else jax_ulysses
        if c.get("block_impl"):
            fn = lambda *a, _f=fn, **kw: _f(*a, block_impl="einsum", **kw)
        want = _reference(fn, devices8, sp, c["q"], c["k"], c["v"],
                          c["causal"])
        got = _joined(results, key)
        assert np.abs(got[0] - want[0]).max() < OUT_TOL, key
        for g, w in zip(got[1:], want[1:]):
            assert np.abs(g - w).max() < GRAD_TOL * max(
                1.0, np.abs(w).max()), key
        # Ulysses is exact attention: the plain whole-sequence call too.
        plain = np.asarray(xla_attention(c["q"], c["k"], c["v"],
                                         causal=c["causal"]))
        assert np.abs(got[0] - plain).max() < OUT_TOL, key
    assert "must divide" in results[0]["indivisible"]


def test_ulysses_beside_tp_and_llama_ring_and_ulysses(devices8, tmp_path):
    """Ulysses on a tp=2, sp=2 mesh equals the plain attention (the
    reference's ``test_ulysses_composes_with_tp_axis``); llama_debug with
    impl="ring" and "ulysses" at dp=2, sp=2, each process on its row and
    sequence chunk (global positions), within 2e-4 of the reference's
    plain model (``test_llama_ulysses_impl_matches_xla``)."""
    import dataclasses

    q_tp = np.asarray(jax.random.normal(jax.random.key(1), (4, 32, 4, 8)))
    jcfg = dataclasses.replace(JAX_CONFIGS["llama_debug"], attn_impl="xla")
    tokens = np.asarray(jax.random.randint(jax.random.key(0), (2, 64), 0,
                                           256))
    model = JaxLlama(jcfg)
    params = model.init(jax.random.key(1), jnp.asarray(tokens))["params"]
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(tokens)))
    state = {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(params), CONFIGS["llama_debug"],
        param_dtype=torch.float32).items()}
    results = run_world("sequence_parallel_meshes", 4, tmp_path,
                        {"q_tp": q_tp, "tokens": tokens, "params": state})
    plain = np.asarray(xla_attention(q_tp, q_tp, q_tp, causal=True))
    for r in results:
        dp, sp = r["coords"]
        assert np.abs(r["tp"] - plain[:, sp * 16:(sp + 1) * 16]).max() \
            < OUT_TOL
        for impl in ("ring", "ulysses"):
            want = ref[dp:dp + 1, sp * 32:(sp + 1) * 32]
            assert np.abs(r[impl] - want).max() < 2e-4, (impl, dp, sp)


def test_hop_modes_follow_global_positions():
    assert [hop_mode(2, j, True) for j in range(4)] == [
        DENSE, DENSE, DIAGONAL, SKIPPED]
    assert {hop_mode(i, j, False) for i in range(4) for j in range(4)} == {
        DENSE}


def test_ring_flash_blocks_reject_an_unsupported_head_dim():
    q = torch.ones(2, 32, 4, 32)     # head_dim 32: no kernel takes it
    with pytest.raises(ValueError, match="unsupported"):
        ring_attention(q, q, q, mesh=None, block_impl="flash")
    with pytest.raises(ValueError, match="unknown block_impl"):
        ring_attention(q, q, q, mesh=None, block_impl="pallas")


class _OnCard:
    """A stand-in for a contiguous bf16 CUDA tensor of ``shape``: what the
    block choice reads."""

    dtype = torch.bfloat16

    def __init__(self, *shape):
        self.shape, self.ndim = torch.Size(shape), len(shape)
        self.device = torch.device("cuda")

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


def test_ring_auto_blocks_on_cuda_tensors_raise_for_an_unsupported_shape():
    """Under "auto", CUDA tensors always take the flash blocks: a chunk
    shape the kernels do not take raises, where it would otherwise run
    the plain f32 blocks on the card.  CPU tensors take the plain blocks
    under "auto" whatever their shape."""
    bad, good = _OnCard(1, 64, 4, 32), _OnCard(1, 64, 4, 128)
    with pytest.raises(ValueError, match="unsupported.*head_dim 32"):
        ring_attention(bad, bad, bad, mesh=None)
    assert use_flash(good, good, "auto")
    assert not use_flash(good, good, "einsum")
    cpu = torch.ones(1, 64, 4, 32)
    assert not use_flash(cpu, cpu, "auto")


def test_sequence_parallel_routes_need_a_mesh_and_refuse_masks():
    """The reference's routing errors (``ops/attention.py:165-176``)."""
    from kubeflow_tpu_torch.parallel import context

    q = torch.ones(1, 8, 4, 16)
    for impl in ("ring", "ulysses"):
        with pytest.raises(RuntimeError, match="needs an active mesh"):
            ops.dot_product_attention(q, q, q, impl=impl)
        with context.global_mesh(object()):
            with pytest.raises(NotImplementedError, match="bias"):
                ops.dot_product_attention(q, q, q, impl=impl,
                                          bias=torch.zeros(1, 1, 8, 8))
            with pytest.raises(NotImplementedError, match="segment_ids"):
                ops.dot_product_attention(
                    q, q, q, impl=impl,
                    segment_ids=torch.zeros(1, 8, dtype=torch.int32))


def test_tp_attention_sums_o_proj_over_tp_in_prefill_and_per_row_decode(
        tmp_path):
    """Attention at tp=2, each process with its heads' shards of the
    projections and the cache: the dense-cache prefill and the per-row
    decode step (the slot pool's) both return the whole layer's output
    on every process (o_proj's partial sums reduced over tp)."""
    rng = np.random.default_rng(3)
    results = run_world("tp_decode", 2, tmp_path, {
        "x": rng.standard_normal((2, 5, 64)).astype(np.float32),
        "x1": rng.standard_normal((2, 1, 64)).astype(np.float32)})
    for r in results:
        for got, want in zip(r["tp"], r["whole"]):
            assert np.abs(got - want).max() < OUT_TOL
