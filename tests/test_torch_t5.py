"""The PyTorch port's T5 (kubeflow_tpu_torch.models.t5) and its seq2seq
generation against the JAX reference on the CPU.

``t5_debug`` (f32) with the reference's initial parameters carried across
by ``models/convert.state_from_flax``; the same numpy inputs go through
both packages.  Checked: the relative-position buckets bit for bit
against the reference's numpy; ``encode`` and ``forward`` logits with a
ragged source mask and cached decode steps' logits within 1e-4; greedy
``generate_seq2seq`` and ``beam_search_seq2seq`` tokens exactly equal;
the gradients of the reference's teacher-forced loss within 1e-4
relative L2 of ``jax.grad``; seeded sampling; beam top-k ties broken as
``jax.lax.top_k`` breaks them; int8 values as ``quantize_params`` makes
them; the registry against the reference's.

Tolerances: 1e-4 absolute on logits whose largest is ~3 (f32 sums in
another order), 1e-4 relative L2 on gradients; tokens and buckets exact.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models import list_models as jax_list_models
from kubeflow_tpu.models.quantize import QTensor, quantize_params
from kubeflow_tpu.models.t5 import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.t5 import T5 as JaxT5
from kubeflow_tpu.models.t5 import \
    relative_position_bucket as jax_bucket
from kubeflow_tpu_torch.models import create_model, list_models
from kubeflow_tpu_torch.models import generate as tgen
from kubeflow_tpu_torch.models.convert import (
    _flax_array,
    _flax_key,
    state_from_flax,
)
from kubeflow_tpu_torch.models.quantize import quantize_model
from kubeflow_tpu_torch.models.t5 import relative_position_bucket

TOL = 1e-4
B, SRC, TGT = 3, 11, 7
NEW = 10


@pytest.fixture(scope="module")
def pair():
    rs = np.random.RandomState(0)
    jm = JaxT5(JAX_CONFIGS["t5_debug"])
    variables = jax.device_get(jm.init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32),
        jnp.ones((1, 4), jnp.int32)))
    model = create_model("t5_debug", device="cpu")
    model.load_state_dict(state_from_flax(variables, model))
    src = rs.randint(2, 128, (B, SRC)).astype(np.int32)
    mask = np.arange(SRC)[None] < np.array([[SRC], [6], [9]])
    return jm, variables, model, src, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 100)])
def test_buckets_bit_equal_reference(bidirectional, num_buckets,
                                     max_distance):
    rel = np.arange(-4096, 4097)
    want = jax_bucket(rel, bidirectional=bidirectional,
                      num_buckets=num_buckets, max_distance=max_distance)
    got = relative_position_bucket(_t(rel), bidirectional=bidirectional,
                                   num_buckets=num_buckets,
                                   max_distance=max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_and_forward_logits_match_reference(pair):
    jm, v, model, src, mask = pair
    tgt = np.random.RandomState(1).randint(0, 128, (B, TGT)).astype(np.int32)
    want_enc = jm.apply(v, jnp.asarray(src), jnp.asarray(mask),
                        method="encode")
    want = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt),
                    source_mask=jnp.asarray(mask))
    with torch.no_grad():
        enc = model.encode(_t(src).long(), _t(mask))
        got = model(_t(src).long(), _t(tgt).long(), source_mask=_t(mask))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=TOL)
    assert got.dtype == torch.float32 and got.shape == (B, TGT, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_cached_decode_steps_match_reference(pair):
    """Cached single-token steps past the exact buckets (16 of the causal
    stack's 32), logits against the reference's ``method="decode"`` with
    its cache, and against the port's own uncached decoder."""
    jm, v, model, src, mask = pair
    steps = 20
    toks = np.random.RandomState(2).randint(0, 128, (B, steps)).astype(
        np.int32)
    toks[:, 0] = 0
    encoded = jm.apply(v, jnp.asarray(src), jnp.asarray(mask),
                       method="encode")
    cache, got = None, []
    with torch.no_grad():
        enc = model.encode(_t(src).long(), _t(mask))
        tcache = model.new_cache(B, steps)
        for i in range(steps):
            variables = dict(v) if cache is None else dict(v, cache=cache)
            want, state = jm.apply(
                variables, encoded, jnp.asarray(toks[:, i:i + 1]),
                source_mask=jnp.asarray(mask), decode=True,
                step=jnp.int32(i), max_decode_len=steps, mutable=["cache"],
                method="decode")
            cache = state["cache"]
            step = model.decode(enc, _t(toks[:, i:i + 1]).long(),
                                source_mask=_t(mask), cache=tcache)
            np.testing.assert_allclose(step.numpy(), np.asarray(want),
                                       atol=TOL, err_msg=f"step {i}")
            got.append(step)
        full = model.decode(enc, _t(toks).long(), source_mask=_t(mask))
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), full.numpy(),
                               atol=TOL)
    assert tcache.index == steps


def _greedy_eos(pair):
    """A token the greedy run emits in its third step: as EOS it freezes
    rows mid-run."""
    _, _, model, src, mask = pair
    out = tgen.generate_seq2seq(model, _t(src).long(), source_mask=_t(mask),
                                max_new_tokens=NEW, eos_token=None)
    return int(out[0, 2])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("eos", ["none", "default", "planted"])
def test_generate_seq2seq_greedy_equals_reference(pair, masked, eos):
    jm, v, model, src, mask = pair
    eos_token = {"none": None, "default": 1,
                 "planted": _greedy_eos(pair)}[eos]
    jmask = jnp.asarray(mask) if masked else None
    want = jgen.generate_seq2seq(jm, v["params"], jnp.asarray(src),
                                 source_mask=jmask, max_new_tokens=NEW,
                                 eos_token=eos_token)
    got = tgen.generate_seq2seq(model, _t(src).long(),
                                source_mask=_t(mask) if masked else None,
                                max_new_tokens=NEW, eos_token=eos_token)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if eos_token is not None:
        for row in got.tolist():
            if eos_token in row:
                hit = row.index(eos_token)
                assert row[hit:] == [eos_token] * (NEW - hit)


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
@pytest.mark.parametrize("beams", [1, 3, 4])
def test_beam_search_seq2seq_equals_reference(pair, beams, length_penalty):
    jm, v, model, src, mask = pair
    eos = _greedy_eos(pair)
    want = jgen.beam_search_seq2seq(
        jm, v["params"], jnp.asarray(src), source_mask=jnp.asarray(mask),
        max_new_tokens=NEW, beams=beams, eos_token=eos,
        length_penalty=length_penalty)
    got = tgen.beam_search_seq2seq(
        model, _t(src).long(), source_mask=_t(mask), max_new_tokens=NEW,
        beams=beams, eos_token=eos, length_penalty=length_penalty)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam1_equals_greedy(pair):
    _, _, model, src, mask = pair
    for eos in (1, _greedy_eos(pair)):
        greedy = tgen.generate_seq2seq(model, _t(src).long(),
                                       source_mask=_t(mask),
                                       max_new_tokens=NEW, eos_token=eos)
        beam1 = tgen.beam_search_seq2seq(model, _t(src).long(),
                                         source_mask=_t(mask),
                                         max_new_tokens=NEW, beams=1,
                                         eos_token=eos)
        assert torch.equal(greedy, beam1)


def test_gradients_match_jax_grad(pair):
    """The reference's teacher-forced loss (tests/test_t5.py): softmax
    cross-entropy of each target token's next, over a ragged source."""
    jm, v, model, src, mask = pair
    tgt = np.random.RandomState(3).randint(0, 128, (B, 6)).astype(np.int32)

    def jax_loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(src), jnp.asarray(tgt),
                          source_mask=jnp.asarray(mask))
        labels = jnp.roll(jnp.asarray(tgt), -1, axis=1)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], labels[:, :-1]).mean()

    want_loss, jgrads = jax.value_and_grad(jax_loss)(v["params"])
    want = state_from_flax({"params": jax.device_get(jgrads)}, model)
    model.requires_grad_(True)
    try:
        logits = model(_t(src).long(), _t(tgt).long(), source_mask=_t(mask))
        labels = torch.roll(_t(tgt).long(), -1, dims=1)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, 128),
                               labels[:, :-1].reshape(-1))
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        model.requires_grad_(False)
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    assert set(params) == set(want)
    for (name, _), g in zip(params.items(), grads):
        assert _rel_l2(g.numpy(), want[name].numpy()) <= TOL, name


def test_seeded_sampling_repeats_and_top1_is_greedy(pair):
    _, _, model, src, mask = pair
    kw = dict(source_mask=_t(mask), max_new_tokens=NEW, eos_token=None)
    run = lambda seed, **s: tgen.generate_seq2seq(
        model, _t(src).long(), generators=tgen.row_generators(seed, B, "cpu"),
        **kw, **s)
    a = run(7, temperature=0.9, top_k=20)
    assert torch.equal(a, run(7, temperature=0.9, top_k=20))
    assert not torch.equal(a, run(8, temperature=0.9, top_k=20))
    assert ((a >= 0) & (a < 128)).all()
    greedy = tgen.generate_seq2seq(model, _t(src).long(), **kw)
    assert torch.equal(run(7, temperature=1.0, top_k=1), greedy)


def test_top_k_ties_go_to_the_lowest_index():
    x = np.random.RandomState(4).randint(0, 4, (6, 40)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 7)
    got_v, got_i = tgen.top_k_lowest_index(_t(x), 7)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("eos_token", [None, 3])
def test_beam_loop_with_planted_ties_equals_reference(eos_token):
    """The shared beam loop on scores full of ties (five levels over a
    vocabulary of 12), the same scores fed to both loops: equal tokens,
    so every top-k and the final ranking broke ties alike."""
    b, beams, vocab, steps = 2, 3, 12, 6

    def logp(token, i):
        base = (np.asarray(token)[..., None] * 7 + np.arange(vocab) * 3
                + i) % 5
        return -base.astype(np.float32)

    logp0 = -(np.arange(b * vocab).reshape(b, vocab) % 4).astype(np.float32)

    want = jgen._beam_loop(
        lambda c, t, i: (jnp.asarray(-((t[..., None] * 7
                                        + jnp.arange(vocab) * 3 + i) % 5)
                                     .astype(jnp.float32)), c),
        jnp.asarray(logp0), {"k": jnp.zeros((b * beams, 1))}, b=b,
        beams=beams, vocab=vocab, eos_token=eos_token, length_penalty=0.6,
        max_new_tokens=steps)

    cache = types.SimpleNamespace(k=[torch.zeros(b * beams, 1)],
                                  v=[torch.zeros(b * beams, 1)])
    got = tgen._beam_loop(lambda t, i: _t(logp(t.numpy(), i)), _t(logp0),
                          cache, beams=beams, eos_token=eos_token,
                          length_penalty=0.6, max_new_tokens=steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_values_equal_quantize_params(pair):
    """``quantize_model`` on a T5 selects and quantizes the leaves
    ``quantize_params`` does, bit for bit; the relative-bias tables and
    the norm scales stay f32."""
    _, v, _, src, mask = pair
    model = create_model("t5_debug", device="cpu")
    model.load_state_dict(state_from_flax(v, model))
    quantize_model(model)
    qparams = quantize_params(v["params"])
    flat_q = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, QTensor):
                flat_q[path] = val
            elif isinstance(val, dict):
                walk(val, path)

    walk(qparams, "")
    mods = dict(model.named_modules())
    quantized = {name for name, mod in mods.items()
                 if getattr(mod, "qweight", None) is not None}
    assert quantized == {_flax_key(p).rsplit(".", 1)[0] for p in flat_q}
    for path, qt in flat_q.items():
        mod = mods[_flax_key(path).rsplit(".", 1)[0]]
        np.testing.assert_array_equal(
            mod.qweight.numpy(), _flax_array(path, np.asarray(qt.q)))
        np.testing.assert_array_equal(mod.scale.numpy().ravel(),
                                      np.asarray(qt.scale).ravel())
    for name in ("encoder_rel_bias", "decoder_rel_bias"):
        emb = mods[name].rel_embedding
        assert emb.dtype == torch.float32
        np.testing.assert_array_equal(
            emb.numpy(), np.asarray(v["params"][name]["rel_embedding"]))
        assert not isinstance(qparams[name]["rel_embedding"], QTensor)
    out = tgen.generate_seq2seq(model, _t(src).long(), source_mask=_t(mask),
                                max_new_tokens=4)
    assert out.shape == (B, 4)


def test_registry_equals_reference_and_every_model_builds():
    """The port registers the reference's 25 names; each builds (on the
    meta device: shapes without storage, so the 47B Mixtral takes no
    memory), and ``t5_debug`` also on the CPU with its weights drawn."""
    names = list_models()
    assert names == jax_list_models()
    for name in names:
        model = create_model(name, device="meta")
        assert sum(p.numel() for p in model.parameters()) > 0, name
    model = create_model("t5_debug", device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    large = create_model("t5_large", device="meta")
    n = sum(p.numel() for p in large.parameters())
    assert 780e6 < n < 790e6, n
