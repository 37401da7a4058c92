"""The port's RMSNorm backward (``rms_norm_bwd`` and ``RMSNormFunction``)
against the JAX reference's VJP on the CPU.

The same numpy inputs go through ``jax.vjp`` of
``kubeflow_tpu.ops.pallas.rms_norm.rms_norm`` (its Pallas forward in
interpret mode, its ``_bwd`` in XLA) and through the port, whose wrappers
take the plain version (``rms_norm_backward``) on CPU tensors.  Both
compute in f32 and round once to the output dtype.  Tolerances: f32
outputs at 1e-5 relative (and 1e-5 absolute near zero); bf16 outputs
within one bf16 ulp; dscale, a sum over rows taken in another order, at
1e-4 relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.pallas import rms_norm as jrms
from kubeflow_tpu_torch.ops import cuda as kernels
from kubeflow_tpu_torch.ops.cuda import rms_norm as krms

EPS = 1e-5
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significand bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def _rel_l2(got, want):
    got = got.double().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rows", [1, 7, 33])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16],
                         ids=["scale_f32", "scale_bf16"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["x_f32", "x_bf16"])
def test_rms_norm_bwd_matches_jax_vjp(x_dtype, scale_dtype, rows, d):
    rs = np.random.RandomState(rows * 1000 + d)
    x = rs.randn(rows, d).astype(np.float32)
    g = rs.randn(rows, d).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(d)).astype(np.float32)
    # Both packages see the same values: rounded to the working dtypes
    # once, here, by torch, then handed over as f32 numpy arrays.
    tx = torch.from_numpy(x).to(x_dtype)
    tg = torch.from_numpy(g).to(x_dtype)
    ts = torch.from_numpy(scale).to(scale_dtype)
    jx, jg = (jnp.asarray(t.float().numpy(), _JNP[x_dtype]) for t in (tx, tg))
    js = jnp.asarray(ts.float().numpy(), _JNP[scale_dtype])
    y_want, vjp = jax.vjp(lambda a, b: jrms.rms_norm(a, b, eps=EPS), jx, js)
    dx_want, ds_want = vjp(jg)

    dx, ds = krms.rms_norm_bwd(tx, ts, tg, eps=EPS)
    assert dx.dtype == x_dtype and ds.dtype == scale_dtype
    _close(dx, dx_want, x_dtype)
    assert _rel_l2(ds, ds_want) <= 1e-4

    # The autograd route the model takes: RMSNormFunction's backward is
    # rms_norm_bwd.
    ax = tx.clone().requires_grad_(True)
    ascale = ts.clone().requires_grad_(True)
    y = krms.RMSNormFunction.apply(ax, ascale, EPS)
    _close(y.detach(), y_want, x_dtype)
    adx, ads = torch.autograd.grad(y, (ax, ascale), tg)
    assert adx.dtype == x_dtype and ads.dtype == scale_dtype
    torch.testing.assert_close(adx, dx, atol=0, rtol=0)
    torch.testing.assert_close(ads, ds, atol=0, rtol=0)


def test_rms_norm_bwd_on_cpu_launches_nothing_and_takes_leading_axes():
    kernels.reset_launch_counts()
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 5, 64).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 5, 64).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rs.randn(64)).astype(np.float32))
    dx, ds = krms.rms_norm_bwd(x, scale, g)
    want_dx, want_ds = krms.rms_norm_backward(x.reshape(10, 64), scale,
                                              g.reshape(10, 64))
    assert dx.shape == x.shape and ds.shape == scale.shape
    torch.testing.assert_close(dx.reshape(10, 64), want_dx, atol=0, rtol=0)
    torch.testing.assert_close(ds, want_ds, atol=0, rtol=0)
    assert set(kernels.launch_counts().values()) == {0}


def test_rms_norm_bwd_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrapper checks before it launches and never falls
    back to the plain version (meta tensors stand in for the card's);
    the widest rows the kernels hold in registers are 16384 bf16 and 8192
    f32 columns."""
    x = torch.empty(4, 64, dtype=torch.bfloat16, device="meta")
    scale = torch.empty(64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda|meta"):
        krms.rms_norm_bwd(x, scale, x)
    assert krms.max_dim(torch.bfloat16) == 16384
    assert krms.max_dim(torch.float32) == 8192


def test_bwd_workspace_rows_cap_at_rows_and_sms(monkeypatch):
    monkeypatch.setattr(krms, "_sm_count", lambda index: 132)
    dev = torch.device("cuda", 0)
    assert krms.bwd_blocks(8192, dev) == 132 * krms.BWD_BLOCKS_PER_SM
    assert krms.bwd_blocks(4, dev) == 4


def test_chip_smoke_counts_the_rms_norm_backward_per_step():
    """chip_smoke.py's expected launches a train step: one backward for
    every norm (two a layer and the final one), for every wrapper."""
    import chip_smoke
    from kubeflow_tpu_torch.models.llama import CONFIGS

    cfg = CONFIGS["llama_1b4"]
    want = chip_smoke.train_launches_per_step(cfg)
    assert set(want) == set(kernels.WRAPPERS)
    assert want["rms_norm_bwd"] == want["rms_norm"] == 2 * 24 + 1 == 49
    assert chip_smoke.train_launches_per_step(cfg, n_layers=2)[
        "rms_norm_bwd"] == 5
    assert chip_smoke.SOURCES["rms_norm_bwd"] == (
        "kubeflow_tpu_torch/ops/csrc/rms_norm.cu",
        "kubeflow_tpu/ops/pallas/rms_norm.py:91")
    assert "rms_norm_bwd" in chip_smoke.TRAIN_KERNELS
