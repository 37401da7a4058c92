"""The PyTorch port's mixture-of-experts MLP (kubeflow_tpu_torch.models.moe)
and the Mixtral decoder against the JAX reference on the CPU.

The same numpy inputs and the reference's parameters go through both
packages.  Tolerances: the MoE layer in f32 within 1e-5 (outputs,
gradients) and 1e-6 (the aux loss), the index dispatch against the
port's dense transcription of the reference's einsums within 1e-6;
``mixtral_debug`` logits within 1e-4, greedy tokens equal.  Routing in
the reference depends on the call's padded length (the capacity) and on
what else shares a batch row, so every comparison is at the reference's
own shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models import paged as jax_paged
from kubeflow_tpu.models.layers import PagedSlots as JaxPagedSlots
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.moe import MoeMlp as JaxMoeMlp
from kubeflow_tpu.train import steps as jsteps
from kubeflow_tpu_torch.models import create_model, paged
from kubeflow_tpu_torch.models import generate as tgen
from kubeflow_tpu_torch.models.convert import expected_leaves, params_from_jax
from kubeflow_tpu_torch.models.moe import MoeMlp, capacity_of, dense_dispatch
from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
from kubeflow_tpu_torch.train import steps

B, S, D, F, E = 2, 16, 32, 48, 4
LR = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer_pair(k, cf, seed=0, tie=False):
    """(reference module, its params, the port's module with them)."""
    jm = JaxMoeMlp(n_experts=E, hidden_dim=F, top_k=k, capacity_factor=cf,
                   dtype=jnp.float32)
    params = jm.init(jax.random.key(seed), jnp.ones((B, S, D)))["params"]
    params = jax.device_get(params)
    if tie:
        # Experts 1 and 3 get zero router columns: their logits are exactly
        # 0 for every token, so they tie, and the lower index must win, as
        # jax.lax.top_k has it.
        kern = np.array(params["router"]["kernel"])
        kern[:, [1, 3]] = 0.0
        params = dict(params, router={"kernel": kern})
    m = MoeMlp(D, F, E, top_k=k, capacity_factor=cf, dtype=torch.float32)
    with torch.no_grad():
        m.router.weight.copy_(_t(params["router"]["kernel"]).T)
        for name in ("w_gate", "w_up", "w_down"):
            getattr(m, name).copy_(_t(params[name]))
    return jm, params, m


def _inputs(seed, masked):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, D).astype(np.float32)
    mask = np.ones((B, S), bool)
    if masked:
        mask[1, 9:] = False          # a right-padded row
    return x, (mask if masked else None)


def _jax_apply(jm, params, x, mask):
    y, cols = jm.apply({"params": params}, jnp.asarray(x),
                       token_mask=None if mask is None else jnp.asarray(mask),
                       mutable=["losses"])
    return np.asarray(y), float(cols["losses"]["moe_aux_loss"][0])


CASES = {
    "top2": (2, 1.25, False, False),
    "top2-mask": (2, 1.25, True, False),
    "top1": (1, 1.25, False, False),
    "top1-mask": (1, 1.25, True, False),
    "drops": (2, 0.5, True, False),
    "tied": (2, 1.25, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_mlp_matches_the_reference(case):
    k, cf, masked, tie = CASES[case]
    jm, params, m = _layer_pair(k, cf, tie=tie)
    x, mask = _inputs(1, masked)
    want_y, want_aux = _jax_apply(jm, params, x, mask)
    tm = None if mask is None else _t(mask)
    with torch.no_grad():
        y, aux = m(_t(x), tm)
        r = m.route(_t(x), tm)
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(aux.item(), want_aux, atol=1e-6, rtol=0)
    real = B * S if mask is None else int(mask.sum())
    if case == "drops":
        assert int(r.keep.sum()) < real * k      # capacity truncation bit
    else:
        assert int(r.keep.sum()) <= real * k
    if tie:
        # Expert 3 is chosen only after expert 1, never alone.
        rank = torch.arange(k)
        at1 = torch.where(r.expert == 1, rank, k).min(-1).values
        at3 = torch.where(r.expert == 3, rank, k).min(-1).values
        assert bool(((at3 == k) | (at1 < at3)).all())
        assert bool((at1 < k).any())
    if mask is not None:
        pad = ~_t(mask)
        assert not bool(r.keep[pad].any())       # padding routes nowhere
        assert torch.equal(y[pad], torch.zeros_like(y[pad]))


@pytest.mark.parametrize("case", ["top2-mask", "drops", "top1"])
def test_moe_mlp_gradients_match_jax_grad(case):
    """d(y.sum() + aux) for the router, the experts and the input."""
    k, cf, masked, _ = CASES[case]
    jm, params, m = _layer_pair(k, cf, seed=2)
    x, mask = _inputs(3, masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(p, xx):
        y, cols = jm.apply({"params": p}, xx, token_mask=jmask,
                           mutable=["losses"])
        return y.sum() + cols["losses"]["moe_aux_loss"][0]

    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    m.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y, aux = m(xt, None if mask is None else _t(mask))
    (y.sum() + aux).backward()
    np.testing.assert_allclose(m.router.weight.grad.numpy(),
                               np.asarray(gp["router"]["kernel"]).T,
                               atol=1e-5, rtol=1e-5)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(m, name).grad.numpy(),
                                   np.asarray(gp[name]), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["top2-mask", "drops", "tied"])
def test_dense_dispatch_equals_the_index_dispatch(case):
    k, cf, masked, tie = CASES[case]
    _, _, m = _layer_pair(k, cf, seed=4, tie=tie)
    x, mask = _inputs(5, masked)
    tm = None if mask is None else _t(mask)
    with torch.no_grad():
        y, aux = m(_t(x), tm)
        yd, auxd, dispatch = dense_dispatch(m, _t(x), tm)
        r = m.route(_t(x), tm)
    assert torch.equal(r.dispatch_mask(), dispatch)
    assert dispatch.shape == (B, S, E, capacity_of(S, k, cf, E))
    np.testing.assert_allclose(y.numpy(), yd.numpy(), atol=1e-6, rtol=1e-6)
    assert aux.item() == auxd.item()


def test_expert_init_counts_the_expert_axis_in_fan_in():
    """flax lecun_normal on (e, d, f): std sqrt(1 / (e d)); the router
    (an f32 Dense) has fan-in d."""
    e, d, f = 8, 64, 128
    m = MoeMlp(d, f, e, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    m.reset_parameters(gen)
    m.router.reset_parameters(gen)
    for w, fan_in in ((m.w_gate, e * d), (m.w_up, e * d), (m.w_down, e * f)):
        std = w.float().std().item()
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5
    assert m.router.weight.dtype == torch.float32
    assert abs(m.router.weight.std().item() - d ** -0.5) < 0.1 * d ** -0.5
    assert m.w_gate.dtype == torch.bfloat16


# -- mixtral_debug ------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(reference mixtral_debug, its params, the port's model with them)."""
    cfg = dataclasses.replace(JAX_CONFIGS["mixtral_debug"], max_seq_len=64)
    jm = JaxLlama(cfg)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    model = create_model("mixtral_debug", device="cpu", max_seq_len=64)
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg))
    return jm, params, model.eval()


def test_mixtral_builds_with_the_reference_leaves():
    for name in ("mixtral_debug", "mixtral_8x7b"):
        cfg = create_model(name, device="meta").cfg
        assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor) == (
            JAX_CONFIGS[name].n_experts, JAX_CONFIGS[name].top_k,
            JAX_CONFIGS[name].capacity_factor)
    model = create_model("mixtral_8x7b", device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for s in expected_leaves(
        model.cfg).values())
    assert round(n / 1e9, 2) == 46.70
    experts = sum(p.numel() for name, p in model.named_parameters()
                  if name.endswith(("w_gate", "w_up", "w_down")))
    assert round(experts / n, 3) == 0.966


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_mixtral_logits_match_the_reference(scan):
    cfg = dataclasses.replace(JAX_CONFIGS["mixtral_debug"], scan_layers=scan)
    jm = JaxLlama(cfg)
    params = jm.init(jax.random.key(3), jnp.ones((1, 8), jnp.int32))["params"]
    tree = jax.device_get(params)
    assert ("layers_scan" in tree) == scan
    model = create_model("mixtral_debug", device="cpu")
    model.load_state_dict(params_from_jax(tree, model.cfg))
    rs = np.random.RandomState(6)
    tokens = rs.randint(0, 256, size=(2, 24))
    want = jm.apply({"params": params}, jnp.asarray(tokens))
    with torch.inference_mode():
        got = model(_t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_mixtral_greedy_generate_on_right_padded_prompts(pair):
    """The prompt pass routes with the prompt mask (pad tokens take no
    expert capacity), as the reference's: greedy tokens equal."""
    jm, params, model = pair
    lens = (3, 9, 14)
    rs = np.random.RandomState(12)
    mask = np.arange(max(lens))[None] < np.array(lens)[:, None]
    tokens = np.where(mask, rs.randint(0, 256, size=mask.shape),
                      0).astype(np.int32)
    want = np.asarray(jgen.generate(jm, params, jnp.asarray(tokens),
                                    prompt_mask=jnp.asarray(mask),
                                    max_new_tokens=10))
    got = tgen.generate(model, _t(tokens).long(), prompt_mask=_t(mask),
                        max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), want)


def _paged_setup(model, rs, b, L, page_len, num_pages):
    """A random pool as the port's cache, a maker of the reference's
    (a fresh one a call: the reference's steps donate theirs) and page
    tables of distinct pages, page 0 left as the null page."""
    cfg = model.cfg
    pool = num_pages * page_len
    ks = rs.randn(cfg.n_layers, pool, cfg.n_kv_heads,
                  cfg.head_dim).astype(np.float32)
    vs = rs.randn(cfg.n_layers, pool, cfg.n_kv_heads,
                  cfg.head_dim).astype(np.float32)
    ids = 1 + rs.permutation(num_pages - 1)[:b * (L // page_len)]
    table = ids.reshape(b, L // page_len)
    jcache = lambda: {
        f"layer_{i}": {"attn": {"paged_key": jnp.asarray(ks[i]),
                                "paged_value": jnp.asarray(vs[i])}}
        for i in range(cfg.n_layers)}
    cache = model.new_paged_cache(pool)
    for i in range(cfg.n_layers):
        cache.k[i].copy_(_t(ks[i]))
        cache.v[i].copy_(_t(vs[i]))
    return cache, jcache, table


def test_mixtral_paged_prefill_chunk_matches_the_reference(pair):
    """One chunk (slots [8, 16)) of a right-padded 2-row prompt over
    scattered pages, routed without a token mask as the reference's
    ``_prefill_chunk`` routes it: the last valid logits within 1e-4."""
    jm, params, model = pair
    rs = np.random.RandomState(8)
    page_len, L, num_pages, start, c = 8, 32, 12, 8, 8
    lens = np.array([14, 11])
    cache, jcache, table = _paged_setup(model, rs, 2, L, page_len, num_pages)
    read = paged.read_indices(_t(table).long(), page_len)
    tokens = rs.randint(0, 256, size=(2, c))
    for i, n in enumerate(lens):
        tokens[i, n - start:] = 0
    positions = np.minimum(np.arange(start, start + c)[None],
                           lens[:, None] - 1)
    mask = np.arange(L)[None] < lens[:, None]
    mask[:, start + c:] = True
    pads = np.where(mask, 0.0, -1e30).astype(np.float32)
    ps = JaxPagedSlots(write=jnp.asarray(read[:, start:start + c].numpy(),
                                         jnp.int32),
                       read=jnp.asarray(read.numpy(), jnp.int32),
                       pool_positions=num_pages * page_len)
    _, want = jax_paged._prefill_chunk(
        jm, jcache(), params, jnp.asarray(tokens), jnp.asarray(positions), ps,
        jnp.int32(start), jnp.asarray(pads), jnp.asarray(lens),
        jnp.zeros((2, 256), jnp.float32))
    with torch.inference_mode():
        got = paged.prefill_chunk(model, cache, _t(tokens).long(),
                                  _t(positions).long(), read, start,
                                  _t(lens).long(), torch.zeros(2, 256))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_mixtral_spec_verify_matches_the_reference(pair):
    """One verify pass (k = 4 drafts a row, 5 queries: capacity 1 an
    expert, so choices drop as in the reference): greedy tokens and
    accepted counts equal the reference's ``_spec_verify``."""
    jm, params, model = pair
    rs = np.random.RandomState(9)
    page_len, L, num_pages, k = 8, 32, 14, 4
    cache, jcache, table = _paged_setup(model, rs, 3, L, page_len, num_pages)
    token = rs.randint(0, 256, size=3)
    drafts = rs.randint(0, 256, size=(3, k))
    pos = np.array([5, 9, 17])
    write = pos.copy()
    pads = np.zeros((3, L), np.float32)
    pads[1, 2:4] = -1e30
    def reference():
        _, g, a = jax_paged._spec_verify(
            jm, jcache(), params, jnp.asarray(token), jnp.asarray(drafts),
            jnp.asarray(pos), jnp.asarray(write), jnp.asarray(pads),
            jnp.asarray(table), page_len=page_len,
            pool_positions=num_pages * page_len)
        return np.asarray(g), np.asarray(a)

    # Row 0 drafts the reference's own greedy tokens, one at a time (each
    # depends on the drafts before it), so it accepts all k.
    for j in range(k):
        drafts[0, j] = reference()[0][0, j]
    want_g, want_a = reference()
    with torch.inference_mode():
        greedy, accepted = paged.spec_verify(
            model, cache, _t(token).long(), _t(drafts).long(),
            _t(pos).long(), _t(write).long(), _t(pads), _t(table).long(),
            page_len=page_len)
    np.testing.assert_array_equal(greedy.numpy(), want_g)
    np.testing.assert_array_equal(accepted.numpy(), want_a)
    assert int(accepted[0]) == k


def test_mixtral_serves_through_every_engine(pair):
    """The fixed pool gives the lock path's tokens for the same request:
    its prefill is the lock path's (the same padded batch), and a
    one-token decode row routes alone (capacity 1 an expert, two distinct
    choices, both kept), whatever shares the pool.  The paged engine's
    greedy tokens equal the reference's paged engine at the same lanes,
    pages and chunks (its chunks route otherwise than one prefill pass,
    in both packages).  Speculative decoding with a Mixtral draft runs;
    its tokens are not held to the plain stream's (the verify pass routes
    k + 1 tokens at capacity 1)."""
    jm, params, model = pair
    rows = [[5, 6, 7, 8, 9, 1, 2], [4, 4, 4], [9, 8, 7, 6, 5, 4, 3, 2, 1]]
    longest = max(len(r) for r in rows)
    prompt = torch.tensor([r + [0] * (longest - len(r)) for r in rows])
    mask = torch.tensor([[True] * len(r) + [False] * (longest - len(r))
                         for r in rows])
    lock = tgen.generate(model, prompt, prompt_mask=mask,
                         max_new_tokens=6).tolist()
    fixed = DecodeScheduler(model, slots=2, slot_len=32, quantum=2)
    try:
        assert fixed.submit(rows, max_new_tokens=6).result() == lock
    finally:
        fixed.stop()
    kw = dict(slots=3, slot_len=32, quantum=4, page_len=8, prefill_chunk=8)
    reqs = [([r], 6) for r in rows]
    jsched = jax_paged.PagedDecodeScheduler(jm, params, **kw)
    want = [jsched.submit(r, max_new_tokens=n).result() for r, n in reqs]
    sched = PagedDecodeScheduler(model, **kw)
    try:
        got = [sched.submit(r, max_new_tokens=n).result() for r, n in reqs]
    finally:
        sched.stop()
    assert got == want
    spec = PagedDecodeScheduler(model, draft_model=model, spec_tokens=4,
                                **kw)
    try:
        out = spec.submit(rows, max_new_tokens=6).result()
        st = spec.stats()
    finally:
        spec.stop()
    assert st["spec_steps_total"] > 0
    assert [len(r) for r in out] == [6] * 3
    assert all(0 <= t < 256 for r in out for t in r)


@pytest.mark.parametrize("ce_chunk", [None, 8], ids=["logits", "ce-chunk"])
def test_mixtral_train_step_with_aux_loss_matches_the_reference(ce_chunk):
    """``make_lm_train_step(aux_loss_weight=0.01)``, with the full logits
    and with the chunked head: the loss, the ``moe_aux_loss`` metric and
    the updated weights against the reference's step."""
    jmodel = JaxLlama(JAX_CONFIGS["mixtral_debug"])
    jstate = jsteps.create_train_state(
        jax.random.key(0), jmodel, jnp.ones((2, 32), jnp.int32),
        optax.adamw(LR))
    rs = np.random.RandomState(9)
    tokens = rs.randint(1, 256, size=(4, 32)).astype(np.int32)
    js, want_m = jax.jit(jsteps.make_lm_train_step(
        aux_loss_weight=0.01, ce_chunk=ce_chunk))(jstate, jnp.asarray(tokens))
    model = create_model("mixtral_debug", device="cpu",
                         param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(
        jax.device_get(jstate.params), model.cfg, param_dtype=torch.float32))
    model.requires_grad_(True)
    state = steps.TrainState(model, steps.adamw(model.parameters(), LR))
    state, metrics = steps.make_lm_train_step(
        aux_loss_weight=0.01, ce_chunk=ce_chunk)(state, _t(tokens).long())
    np.testing.assert_allclose(metrics["loss"].item(),
                               float(want_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["moe_aux_loss"].item(),
                               float(want_m["moe_aux_loss"]), atol=1e-6,
                               rtol=0)
    want = params_from_jax(jax.device_get(js.params), model.cfg,
                           param_dtype=torch.float32)
    start = params_from_jax(jax.device_get(jstate.params), model.cfg,
                            param_dtype=torch.float32)
    for name, p in model.state_dict().items():
        moved, got = want[name] - start[name], p - start[name]
        # Adam's first step moves each weight by about lr (see
        # test_torch_train's three-step test): the movement as a whole
        # within 1e-3 relative L2 of the reference's.
        dist = (got - moved).norm() / moved.norm().clamp(min=1e-12)
        assert dist.item() <= 1e-3, (name, dist.item())


def test_train_run_trains_mixtral_debug(capsys):
    """The trainer CLI passes no aux flag (as the reference's); a Mixtral
    trains through it."""
    from kubeflow_tpu_torch.train import run

    assert run.main(["--model", "mixtral_debug", "--steps", "2", "--batch",
                     "2", "--seq", "32", "--log-every", "1",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("done: step 2 loss=")
    assert sum(line.startswith("train_step ") for line in out) == 2


@pytest.mark.parametrize("mode", ["block", "mlp"])
def test_mixtral_remat_gives_the_same_loss_aux_and_grads(mode):
    """Remat recomputes each block (or its MoE MLP) with the same routing:
    the loss, the aux loss and every gradient as without remat (f32,
    within 1e-6 relative)."""
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        1, 256, size=(2, 16)))
    out = {}
    for remat in (False, True):
        model = create_model("mixtral_debug", device="cpu",
                             param_dtype=torch.float32, remat=remat,
                             remat_mode=mode)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss, aux = steps.lm_loss(model, params, tokens, with_aux=True)
        grads = torch.autograd.grad(loss + 0.01 * aux,
                                    list(params.values()))
        out[remat] = (loss.item(), aux.item(), grads)
    (l0, a0, g0), (l1, a1, g1) = out[False], out[True]
    assert abs(l1 - l0) <= 1e-6 * abs(l0) and abs(a1 - a0) <= 1e-6 * a0
    for x, y in zip(g0, g1):
        torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-7)


def test_load_service_serves_mixtral_cut_in_depth():
    """``n_layers`` (``--n-layers``) cuts the depth at full width: the way
    ``mixtral_8x7b`` is served on one card."""
    from kubeflow_tpu_torch.models.serve import load_service

    service = load_service("mixtral_debug", device="cpu", seed=1,
                           n_layers=1)
    cfg = service.model.cfg
    assert (cfg.n_layers, cfg.dim, cfg.n_experts) == (1, 64, 4)
    assert len(service.model.layers) == 1
    out = service.generate([[3, 1, 4, 1, 5], [9, 2]], max_new_tokens=3)
    assert [len(r) for r in out] == [3, 3]
