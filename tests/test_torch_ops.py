"""PyTorch port ops (kubeflow_tpu_torch.ops) against the JAX reference.

The same numpy inputs go through the JAX function (its Pallas kernel in
interpret mode, or its XLA path) and the port's plain version, which is
what the port's kernel wrappers run on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu import ops as jops
from kubeflow_tpu.ops.attention import xla_attention
from kubeflow_tpu.ops.pallas import flash_attention as jfa
from kubeflow_tpu.ops.pallas import flash_decode as jfd
from kubeflow_tpu_torch import ops
from kubeflow_tpu_torch.ops import cuda as kernels


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significand bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# -- RMSNorm (K1) -------------------------------------------------------------


@pytest.mark.parametrize("rows", [3, 16])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_rms_norm_matches_reference_f32(rows, jax_impl):
    rs = np.random.RandomState(rows)
    x = rs.randn(rows, 128).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(128)).astype(np.float32)
    want = np.asarray(jops.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                    eps=1e-5, impl=jax_impl))
    got = ops.rms_norm(_t(x), _t(scale), eps=1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("rows", [3, 16])
def test_rms_norm_bf16_within_one_ulp(rows):
    rs = np.random.RandomState(10 + rows)
    x32 = rs.randn(rows, 128).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(128)).astype(np.float32)
    xj = jnp.asarray(x32, jnp.bfloat16)
    want = np.asarray(jops.rms_norm(xj, jnp.asarray(scale), eps=1e-5,
                                    impl="xla").astype(jnp.float32))
    got = ops.rms_norm(_t(x32).to(torch.bfloat16), _t(scale),
                       eps=1e-5).float().numpy()
    assert got.dtype == np.float32
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp)


# -- attention (K2) -----------------------------------------------------------


def _qkv(seed, b=2, sq=256, sk=256, h=4, kv_h=2, d=64):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, kv_h, d).astype(np.float32)
    v = rs.randn(b, sk, kv_h, d).astype(np.float32)
    return q, k, v


def _segments(b, s):
    cuts = [[60, 200], [128, 129]]
    pos = np.arange(s)[None]
    return (1 + (pos >= np.array(cuts)[:, :1])
            + (pos >= np.array(cuts)[:, 1:])).astype(np.int32)[:b]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_plain_attention_matches_pallas_flash(causal, packed):
    q, k, v = _qkv(1)
    seg = _segments(2, 256) if packed else None
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = ops.dot_product_attention(
        _t(q), _t(k), _t(v), causal=causal,
        segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_plain_attention_matches_xla_bias_and_cross_length_causal():
    q, k, v = _qkv(2, sq=64, sk=256)
    bias = np.random.RandomState(3).randn(2, 1, 64, 256).astype(np.float32)
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, bias=jnp.asarray(bias))
    got = ops.dot_product_attention(_t(q), _t(k), _t(v), causal=True,
                                    bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


# -- decode attention (K5) ----------------------------------------------------


def test_plain_decode_matches_pallas_flash_decode():
    q, k, v = _qkv(4, sq=1, sk=256)
    valid = np.arange(256)[None] < np.array([[100], [256]])
    rows = np.where(valid, 0.0, -1e30).astype(np.float32)
    want = jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(rows))
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("masked", ["every_slot", "run_of_96"])
def test_plain_decode_matches_pallas_flash_decode_on_masked_rows(masked):
    """The semantics the decode kernel keeps where the bias masks with the
    reference's -1e30: a row masked in every slot averages V uniformly; a
    row masked over one contiguous run of slots (a whole slice of one
    block of the kernel's cluster) attends to the rest."""
    rs = np.random.RandomState(21)
    S = 256
    q = rs.randn(2, 1, 8, 64).astype(np.float32)
    k = rs.randn(2, S, 2, 64).astype(np.float32)
    v = rs.randn(2, S, 2, 64).astype(np.float32)
    rows = np.where(rs.rand(2, S) < 0.1, -1e30, 0.0).astype(np.float32)
    if masked == "every_slot":
        rows[0] = -1e30
    else:
        rows[:, 64:160] = -1e30
    want = np.asarray(jfd.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(rows)))
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(rows)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if masked == "every_slot":
        uniform = v[0].mean(axis=0).repeat(4, axis=0)  # kv head j // 4
        np.testing.assert_allclose(got[0, 0], uniform, atol=1e-5, rtol=0)


# -- routing and the wrappers on CPU tensors ----------------------------------


def test_wrappers_take_plain_path_on_cpu_without_launching():
    kernels.reset_launch_counts()
    q, k, v = (_t(a) for a in _qkv(5, sq=16, sk=16))
    scale = torch.ones(64)
    rows = torch.zeros(2, 16)
    y = kernels.rms_norm.rms_norm(q, scale)
    o = kernels.flash_attention.flash_attention(q, k, v, causal=True)
    od = kernels.flash_decode.flash_decode(q[:, :1], k, v, rows)
    torch.testing.assert_close(y, ops.plain_rms_norm(q, scale))
    torch.testing.assert_close(o, ops.plain_attention(q, k, v, causal=True))
    torch.testing.assert_close(od, ops.plain_decode(q[:, :1], k, v, rows))
    assert kernels.launch_counts() == {
        "rms_norm": 0, "rms_norm_bwd": 0, "flash_attention_fwd": 0,
        "flash_attention_fwd_lse": 0, "flash_attention_dq": 0,
        "flash_attention_dkv": 0, "flash_decode": 0}


def test_kernel_impl_on_cpu_raises_and_unported_impls_name_roadmap():
    q, k, v = (_t(a) for a in _qkv(6, sq=8, sk=8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rms_norm(q, torch.ones(64), impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.dot_product_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, :1], k, v, torch.zeros(2, 8),
                             impl="kernel")
    # The sequence-parallel routes need an active mesh, as in the
    # reference (kubeflow_tpu/ops/attention.py:165-172).
    for impl in ("ring", "ulysses"):
        with pytest.raises(RuntimeError, match="needs an active mesh"):
            ops.dot_product_attention(q, k, v, impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.rms_norm(q, torch.ones(64), impl="pallas")


def test_biased_attention_off_the_cpu_raises_instead_of_going_plain():
    """The flash kernel takes no bias: off the CPU, "auto" must refuse a
    biased call rather than run the plain version (meta tensors stand in
    for the card's here); "plain" takes it on any device."""
    q, k, v = (torch.empty(1, 8, 2, 64, device="meta") for _ in range(3))
    bias = torch.empty(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no additive bias"):
        ops.dot_product_attention(q, k, v, bias=bias, impl="auto")
    out = ops.dot_product_attention(q, k, v, bias=bias, impl="plain")
    assert out.shape == q.shape and out.device.type == "meta"


def test_plain_route_equals_auto_route_on_cpu():
    q, k, v = (_t(a) for a in _qkv(7, sq=32, sk=32))
    torch.testing.assert_close(
        ops.dot_product_attention(q, k, v, causal=True, impl="plain"),
        ops.dot_product_attention(q, k, v, causal=True, impl="auto"),
        atol=0, rtol=0)
    assert jax.devices()[0].platform == "cpu"
