"""The PyTorch port's training path against the JAX reference on the CPU:
the flash attention backward (the plain versions the port's wrappers run
on CPU tensors, and autograd through the ops), the RMSNorm backward, the
losses, the LM grad step, AdamW, gradient accumulation, remat and the
trainer CLI.

The same numpy inputs go through both packages; the JAX Pallas kernels
run in interpret mode.  Tolerances are f32 rounding of the same math
summed in another order unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu import ops as jops
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.ops.pallas import flash_attention as jfa
from kubeflow_tpu.train import steps as jsteps
from kubeflow_tpu_torch import ops
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.ops import cuda as kernels
from kubeflow_tpu_torch.ops.cuda import flash_attention as kfa
from kubeflow_tpu_torch.ops.cuda import rms_norm as krms
from kubeflow_tpu_torch.train import run as trainer
from kubeflow_tpu_torch.train import steps


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, b=2, s=256, h=4, kv_h=2, d=64):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, s, kv_h, d).astype(np.float32)
    v = rs.randn(b, s, kv_h, d).astype(np.float32)
    do = rs.randn(b, s, h, d).astype(np.float32)
    return q, k, v, do


def _segments(b, s):
    """Three documents per row and a pad tail (segment 0) in row 1: pad
    rows attend only to pad rows."""
    pos = np.arange(s)[None]
    cuts = np.array([[60, 200], [100, 129]])[:b]
    seg = (1 + (pos >= cuts[:, :1]) + (pos >= cuts[:, 1:])).astype(np.int32)
    seg[1, 220:] = 0
    return seg


def _close(got, want, rtol):
    """Relative L2 distance within ``rtol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= rtol, err


# -- K2-lse, K3, K4: plain versions against the reference ---------------------


@pytest.mark.parametrize("causal", [False, True])
def test_plain_lse_matches_reference_with_lse(causal):
    q, k, v, _ = _qkv(1)
    o_ref, lse_ref = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o, lse = kfa.flash_attention_fwd_lse(_t(q), _t(k), _t(v), causal=causal)
    assert lse.shape == (2, 4, 256) and lse.dtype == torch.float32
    # f32 logsumexp of the same logits: m + log(l) against torch.logsumexp.
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("causal,kv_h,packed", [
    (True, 4, False), (True, 2, False), (False, 1, False), (True, 2, True)],
    ids=["causal", "causal-gqa2", "full-gqa4", "causal-gqa2-segments"])
def test_plain_backward_matches_jax_grad(causal, kv_h, packed):
    q, k, v, do = _qkv(2, kv_h=kv_h)
    seg = _segments(2, 256) if packed else None

    def loss(q_, k_, v_):
        o = jfa.flash_attention(
            q_, k_, v_, causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    tseg = None if seg is None else _t(seg)
    kw = dict(causal=causal, segment_ids=tseg)
    # The wrappers' CPU path: the plain versions of K2-lse, K3, K4.
    o, lse = kfa.flash_attention_fwd_lse(tq, tk, tv, **kw)
    dq, delta = kfa.flash_attention_dq(tq, tk, tv, o, tdo, lse, **kw)
    dk, dv = kfa.flash_attention_dkv(tq, tk, tv, tdo, lse, delta, **kw)
    assert dk.shape == tk.shape and dv.shape == tv.shape
    # Autograd through the public op (the route a CPU model takes).
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = ops.dot_product_attention(*leaves, **kw)
    auto = torch.autograd.grad(out, leaves, tdo)
    for got_k, got_a, ref in zip((dq, dk, dv), auto, want):
        np.testing.assert_allclose(got_k.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


def test_with_lse_backward_takes_the_lse_cotangent():
    q, k, v, do = _qkv(3)
    gl = np.random.RandomState(4).randn(2, 4, 256).astype(np.float32)

    def loss(q_, k_, v_):
        o, lse = jfa.flash_attention_with_lse(q_, k_, v_, causal=True)
        return jnp.sum(o * jnp.asarray(do)) + jnp.sum(
            lse[..., 0] * jnp.asarray(gl))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo, tgl = _t(q), _t(k), _t(v), _t(do), _t(gl)
    o, lse = kfa.flash_attention_fwd_lse(tq, tk, tv, causal=True)
    dq, delta = kfa.flash_attention_dq(tq, tk, tv, o, tdo, lse, causal=True,
                                       g_lse=tgl)
    dk, dv = kfa.flash_attention_dkv(tq, tk, tv, tdo, lse, delta,
                                     causal=True)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o2, lse2 = kfa.flash_attention_with_lse(*leaves, causal=True)
    auto = torch.autograd.grad((o2, lse2), leaves, (tdo, tgl))
    for got_k, got_a, ref in zip((dq, dk, dv), auto, want):
        np.testing.assert_allclose(got_k.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_a.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


def test_backward_wrappers_on_cpu_launch_nothing_and_flag_bad_operands():
    kernels.reset_launch_counts()
    q, k, v, do = (_t(a) for a in _qkv(5, s=16))
    o, lse = kfa.flash_attention_fwd_lse(q, k, v, causal=True)
    dq, delta = kfa.flash_attention_dq(q, k, v, o, do, lse, causal=True)
    kfa.flash_attention_dkv(q, k, v, do, lse, delta, causal=True)
    assert set(kernels.launch_counts().values()) == {0}
    # The CUDA-side checks: bf16 operands of q's shape, f32 [b, h, sq].
    qb, ob, dob = (t.bfloat16().contiguous() for t in (q, o, do))
    kfa._check_bwd(qb, ob, dob, lse, g_lse=lse, delta=delta)
    with pytest.raises(ValueError, match="do"):
        kfa._check_bwd(qb, ob, dob[:, :8].contiguous(), lse)
    with pytest.raises(ValueError, match="o "):
        kfa._check_bwd(qb, o, dob, lse)
    with pytest.raises(ValueError, match="lse"):
        kfa._check_bwd(qb, ob, dob, lse[..., 1:].contiguous())
    with pytest.raises(ValueError, match="delta"):
        kfa._check_bwd(qb, None, dob, lse, delta=delta.double())


# -- RMSNorm backward ---------------------------------------------------------


def test_rms_norm_backward_matches_pallas_grads():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 8, 128).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(128)).astype(np.float32)
    g = rs.randn(2, 8, 128).astype(np.float32)

    def loss(x_, s_):
        return jnp.sum(jops.rms_norm(x_, s_, eps=1e-5, impl="pallas")
                       * jnp.asarray(g))

    want_dx, want_ds = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(scale))
    # The backward RMSNormFunction runs on the card ...
    dx, ds = krms.rms_norm_backward(_t(x), _t(scale), _t(g), eps=1e-5)
    # ... and autograd through the CPU route.
    tx, ts = _t(x).requires_grad_(True), _t(scale).requires_grad_(True)
    adx, ads = torch.autograd.grad(ops.rms_norm(tx, ts, eps=1e-5), (tx, ts),
                                   _t(g))
    for got in (dx, adx):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_dx),
                                   atol=1e-5, rtol=1e-5)
    for got in (ds, ads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_ds),
                                   atol=1e-4, rtol=1e-5)


# -- losses -------------------------------------------------------------------


def test_token_nll_and_cross_entropy_values_and_grads():
    rs = np.random.RandomState(7)
    logits = (3 * rs.randn(2, 16, 50)).astype(np.float32)
    labels = rs.randint(0, 50, size=(2, 16)).astype(np.int32)
    w = (rs.rand(2, 16) > 0.3).astype(np.float32)
    for weights in (None, w):
        def loss(x):
            return jsteps.cross_entropy(
                x, jnp.asarray(labels),
                weights=None if weights is None else jnp.asarray(weights))

        want, want_g = jax.value_and_grad(loss)(jnp.asarray(logits))
        tl = _t(logits).requires_grad_(True)
        got = steps.cross_entropy(
            tl, _t(labels), None if weights is None else _t(weights))
        (got_g,) = torch.autograd.grad(got, tl)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   atol=1e-7, rtol=1e-5)
    nll = steps.token_nll(_t(logits), _t(labels))
    want_nll = jsteps._token_nll(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), atol=1e-5,
                               rtol=1e-6)


def test_chunked_cross_entropy_values_and_grads():
    rs = np.random.RandomState(8)
    hidden = rs.randn(2, 32, 16).astype(np.float32)
    kernel = (0.3 * rs.randn(16, 40)).astype(np.float32)   # [D, V]
    labels = rs.randint(0, 40, size=(2, 32)).astype(np.int32)
    w = (rs.rand(2, 32) > 0.2).astype(np.float32)

    def loss(h, kern):
        return jsteps.chunked_cross_entropy(h, kern, jnp.asarray(labels),
                                            jnp.asarray(w), chunk=8)

    want, (want_dh, want_dk) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(kernel))
    th = _t(hidden).requires_grad_(True)
    tw = _t(kernel.T.copy()).requires_grad_(True)           # [V, D]
    got = steps.chunked_cross_entropy(th, tw, _t(labels), _t(w), chunk=8)
    dh, dw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(dw.numpy().T, np.asarray(want_dk), atol=1e-6,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        steps.chunked_cross_entropy(th, tw, _t(labels), chunk=5)


# -- the LM step against the JAX trainer --------------------------------------

LR = 1e-2


@pytest.fixture(scope="module")
def jax_state():
    """The reference's llama_debug train state (f32 params, AdamW)."""
    model = JaxLlama(JAX_CONFIGS["llama_debug"])
    return jsteps.create_train_state(
        jax.random.key(0), model, jnp.ones((2, 32), jnp.int32),
        optax.adamw(LR))


def _port_state(params, **cfg):
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32, **cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg,
                                          param_dtype=torch.float32))
    model.requires_grad_(True)
    return steps.TrainState(model, steps.adamw(model.parameters(), LR))


def _batch(packed):
    rs = np.random.RandomState(9)
    tokens = rs.randint(1, 256, size=(4, 32)).astype(np.int32)
    if not packed:
        return tokens, None
    seg = np.repeat(np.array([[1, 2, 3, 4], [1, 1, 2, 0],
                              [1, 1, 1, 1], [1, 2, 2, 0]]), 8, axis=1)
    tokens = np.where(seg == 0, 0, tokens).astype(np.int32)
    return tokens, seg.astype(np.int32)


def _as_batch(tokens, seg, convert):
    return convert(tokens) if seg is None else (convert(tokens), convert(seg))


@pytest.mark.parametrize("packed,grad_dtype,ce_chunk", [
    (False, None, None), (True, None, None), (False, "bf16", None),
    (True, None, 8)], ids=["plain", "segments", "bf16-grads", "ce-chunk"])
def test_lm_grad_fn_matches_jax_step(jax_state, packed, grad_dtype,
                                     ce_chunk):
    tokens, seg = _batch(packed)
    jgrad = jsteps.make_lm_grad_fn(
        grad_dtype=jnp.bfloat16 if grad_dtype else None, ce_chunk=ce_chunk)
    want_grads, _, want_m = jgrad(jax_state, _as_batch(tokens, seg,
                                                       jnp.asarray))
    state = _port_state(jax_state.params)
    grads, metrics = steps.make_lm_grad_fn(
        grad_dtype=torch.bfloat16 if grad_dtype else None,
        ce_chunk=ce_chunk)(state, _as_batch(tokens, seg, _t))
    np.testing.assert_allclose(metrics["loss"].item(), float(want_m["loss"]),
                               rtol=1e-5)
    want = params_from_jax(jax.device_get(want_grads), state.module.cfg,
                           param_dtype=torch.float32)
    assert set(grads) == set(want)
    for name, g in grads.items():
        if grad_dtype:
            # bf16 gradients of the same f32 math: within two bf16 ulps
            # (2^-7 relative) of the reference's bf16 gradient.
            assert g.dtype == torch.bfloat16, name
            _close(g.float(), want[name], 2 ** -7)
        else:
            assert g.dtype == torch.float32, name
            _close(g, want[name], 1e-4)


def test_adamw_three_steps_match_jax_trainer(jax_state):
    jstep = jax.jit(jsteps.make_lm_train_step())
    state = _port_state(jax_state.params)
    step = steps.make_lm_train_step()
    js = jax_state
    for i in range(3):
        tokens, seg = _batch(packed=bool(i % 2))
        js, _ = jstep(js, _as_batch(tokens, seg, jnp.asarray))
        state, _ = step(state, _as_batch(tokens, seg, _t))
    assert state.step == 3 and int(js.step) == 3
    want = params_from_jax(jax.device_get(js.params), state.module.cfg,
                           param_dtype=torch.float32)
    start = params_from_jax(jax.device_get(jax_state.params),
                            state.module.cfg, param_dtype=torch.float32)
    for name, p in state.module.state_dict().items():
        # Adam's early steps move each weight by about lr.  A weight whose
        # gradient is near 0 moves by g / (|g| + eps), which f32 rounding
        # of g can swing by up to lr, so hold the movement as a whole:
        # the port's within 1e-3 relative L2 of the reference's.
        moved = want[name] - start[name]
        assert moved.abs().max().item() > 0.5 * LR, name
        _close(p - start[name], moved, 1e-3)


def test_grad_accumulation_equals_the_full_batch(jax_state):
    tokens, seg = _batch(packed=False)
    full = _port_state(jax_state.params)
    accum = _port_state(jax_state.params)
    full, m_full = steps.make_lm_train_step()(full, _t(tokens))
    accum, m_acc = steps.make_grad_accum_step(steps.make_lm_grad_fn(), 2)(
        accum, _t(tokens))
    np.testing.assert_allclose(m_acc["loss"].item(), m_full["loss"].item(),
                               rtol=1e-6)
    start = params_from_jax(jax.device_get(jax_state.params),
                            full.module.cfg, param_dtype=torch.float32)
    for (name, a), b in zip(accum.module.state_dict().items(),
                            full.module.state_dict().values()):
        # The same update up to f32 rounding of the summed gradient (see
        # the AdamW test for why the movement is held as a whole).
        _close(a - start[name], b - start[name], 1e-4)
    with pytest.raises(ValueError, match="divisible"):
        steps.make_grad_accum_step(steps.make_lm_grad_fn(), 3)(
            accum, _t(tokens))


@pytest.mark.parametrize("grad_dtype", [None, torch.bfloat16],
                         ids=["f32-grads", "bf16-grads"])
@pytest.mark.parametrize("mode", ["block", "mlp"])
def test_remat_gives_the_same_grads(jax_state, mode, grad_dtype):
    tokens, seg = _batch(packed=True)
    batch = (_t(tokens), _t(seg))
    base = _port_state(jax_state.params)
    remat = _port_state(jax_state.params, remat=True, remat_mode=mode)
    grad_fn = steps.make_lm_grad_fn(grad_dtype=grad_dtype)
    g0, m0 = grad_fn(base, batch)
    g1, m1 = grad_fn(remat, batch)
    assert m0["loss"].item() == m1["loss"].item()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-7, rtol=1e-6)
    # The recompute runs with the parameters the loss was given, not the
    # module's own: scaled copies give the scaled model's gradients.
    grads = []
    for state in (base, remat):
        params = {n: (1.5 * p.detach()).to(grad_dtype or p.dtype)
                  .requires_grad_(True)
                  for n, p in state.module.named_parameters()}
        loss = steps.lm_loss(state.module, params, *batch)
        grads.append(torch.autograd.grad(loss, list(params.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-7, rtol=1e-6)
    with pytest.raises(ValueError, match="remat_mode"):
        create_model("llama_debug", device="cpu", remat_mode="layer")


def test_return_hidden_is_the_head_input(jax_state):
    state = _port_state(jax_state.params)
    tokens, _ = _batch(packed=False)
    with torch.no_grad():
        hidden = state.module(_t(tokens), return_hidden=True)
        logits = state.module(_t(tokens))
    torch.testing.assert_close(state.module.lm_head(hidden), logits)


def test_bf16_compute_from_f32_storage_matches_bf16_storage():
    f32 = create_model("llama_debug", device="cpu", dtype=torch.bfloat16,
                       param_dtype=torch.float32)
    f32.reset_parameters(torch.Generator().manual_seed(0))
    bf16 = create_model("llama_debug", device="cpu", dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    assert f32.layers[0].mlp.up_proj.weight.dtype == torch.float32
    assert bf16.layers[0].mlp.up_proj.weight.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in f32.parameters())
    tokens = torch.from_numpy(_batch(packed=False)[0])
    with torch.no_grad():
        torch.testing.assert_close(f32(tokens), bf16(tokens), atol=0, rtol=0)


# -- the trainer CLI ----------------------------------------------------------


def test_train_run_main_on_cpu_prints_done(capsys):
    rc = trainer.main(["--model", "llama_debug", "--steps", "3", "--batch",
                       "2", "--seq", "32", "--log-every", "1", "--packed",
                       "--grad-dtype", "bf16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0] == ("devices=1 mesh={'pp': 1, 'dp': 1, 'fsdp': 1, "
                      "'ep': 1, 'tp': 1, 'sp': 1} device=cpu")
    assert sum(line.startswith("train_step step=") for line in out) == 3
    done = out[-1]
    assert done.startswith("done: step 3 loss=")
    assert "tokens_per_sec=" in done and "mfu=" in done


def test_train_run_without_a_card_or_with_unported_flags_stops(capsys):
    with pytest.raises(SystemExit):
        trainer.main(["--steps", "1"])
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    # A mesh larger than the one process stops with the reference's
    # device-count error (kubeflow_tpu/parallel/mesh.py:89-93).
    with pytest.raises(SystemExit):
        trainer.main(["--mesh", "dp=2", "--device", "cpu"])
    assert ("mesh {'pp': 1, 'dp': 2, 'fsdp': 1, 'ep': 1, 'tp': 1, 'sp': 1} "
            "needs 2 devices, have 1") in capsys.readouterr().err
    # The image task is ported; its memory levers stay the lm task's, as
    # in the reference, and it trains a classifier only.
    for flags, msg in ((["--grad-dtype", "bf16"], "apply to the lm task"),
                       (["--ce-chunk", "8"], "apply to the lm task"),
                       ([], "trains a resnet or vit model")):
        with pytest.raises(SystemExit):
            trainer.main(["--task", "image", "--device", "cpu"] + flags)
        assert msg in capsys.readouterr().err
