"""PyTorch port generation (kubeflow_tpu_torch.models.generate) against the
JAX reference: greedy tokens exactly equal on a ragged right-padded
batch, the flash-prefill routing against the reference's cached-bias
prefill, the two-phase split, EOS freezing, and per-row sampling under
injected Gumbel noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models import generate as tgen
from kubeflow_tpu_torch.models.convert import params_from_jax

LENS = (3, 7, 12)
NEW = 8


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(JAX_CONFIGS["llama_debug"])
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    model = create_model("llama_debug", device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg))
    return jm, params, model


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(11)
    longest = max(LENS)
    mask = np.arange(longest)[None] < np.array(LENS)[:, None]
    tokens = np.where(mask, rs.randint(0, 256, size=(len(LENS), longest)), 0)
    return tokens.astype(np.int32), mask


@pytest.fixture(scope="module")
def jax_greedy(pair, batch):
    jm, params, _ = pair
    tokens, mask = batch
    return np.asarray(jgen.generate(jm, params, jnp.asarray(tokens),
                                    prompt_mask=jnp.asarray(mask),
                                    max_new_tokens=NEW))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_greedy_tokens_equal_reference_exactly(pair, batch, jax_greedy):
    _, _, model = pair
    tokens, mask = batch
    got = tgen.generate(model, _t(tokens).long(), prompt_mask=_t(mask),
                        max_new_tokens=NEW)
    assert got.shape == (len(LENS), NEW)
    np.testing.assert_array_equal(got.numpy(), jax_greedy)


def test_prefill_logits_match_cached_bias_prefill(pair, batch):
    """The port's prefill attends causally over the fresh tokens (the flash
    route); the reference attends over the whole cache with causal + pad
    bias.  Every valid position must agree."""
    jm, params, model = pair
    tokens, mask = batch
    cache_len = tokens.shape[1] + NEW
    positions = np.maximum(np.cumsum(mask, axis=-1) - 1, 0)
    slot_valid = np.concatenate(
        [mask, np.ones((len(LENS), NEW), bool)], axis=-1)
    pad_bias = np.where(slot_valid, 0.0, -1e30).astype(np.float32)
    want, _ = jm.apply({"params": params}, jnp.asarray(tokens),
                       positions=jnp.asarray(positions), decode=True,
                       mask_bias=jnp.asarray(pad_bias)[:, None, None, :],
                       cache_len=cache_len, mutable=["cache"])
    pos_t, lengths = tgen.prompt_positions(_t(mask))
    np.testing.assert_array_equal(pos_t.numpy(), positions)
    with torch.inference_mode():
        got = model(_t(tokens).long(), positions=pos_t,
                    cache=model.new_cache(len(LENS), cache_len),
                    pad_bias=tgen.pad_bias_rows(_t(mask), cache_len))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy()[mask], want[mask], atol=1e-4,
                               rtol=0)


def test_two_phase_equals_one_shot(pair, batch, jax_greedy):
    _, _, model = pair
    tokens, mask = batch
    first, state = tgen.generate_prefill(model, _t(tokens).long(),
                                         prompt_mask=_t(mask),
                                         max_new_tokens=NEW)
    np.testing.assert_array_equal(first.numpy(), jax_greedy[:, 0])
    out = tgen.generate_decode(model, state)
    np.testing.assert_array_equal(out.numpy(), jax_greedy)
    _, state = tgen.generate_prefill(model, _t(tokens).long(),
                                     prompt_mask=_t(mask),
                                     max_new_tokens=NEW)
    with pytest.raises(ValueError, match="budget"):
        tgen.generate_decode(model, state, max_new_tokens=NEW + 1)


def test_eos_freezing_matches_reference(pair, batch, jax_greedy):
    jm, params, model = pair
    tokens, mask = batch
    eos = int(jax_greedy[1, 3])  # a token row 1 emits mid-stream
    want = jgen.generate(jm, params, jnp.asarray(tokens),
                         prompt_mask=jnp.asarray(mask), max_new_tokens=NEW,
                         eos_token=eos)
    got = tgen.generate(model, _t(tokens).long(), prompt_mask=_t(mask),
                        max_new_tokens=NEW, eos_token=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1, 3:] == eos).all()


def test_cache_length_checked_against_max_seq_len(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="max_seq_len"):
        tgen.generate(model, torch.zeros(1, 250, dtype=torch.long),
                      max_new_tokens=7)


@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("top_k", [0, 5])
def test_sample_rows_match_reference_under_injected_gumbel(temp, top_k):
    b, vocab = 4, 64
    logits = np.random.RandomState(5).randn(b, vocab).astype(np.float32)
    temps = np.array([temp, temp, 0.0, temp], np.float32)
    top_ks = np.full(b, top_k, np.int32)
    keys = jax.random.split(jax.random.key(9), b)
    _, subs = jgen.split_row_rngs(keys)
    want = jgen.sample_logits_rows(jnp.asarray(logits), subs,
                                   temps=jnp.asarray(temps),
                                   top_ks=jnp.asarray(top_ks))
    noise = np.stack([np.asarray(jax.random.gumbel(s, (vocab,)))
                      for s in subs])
    got = tgen.sample_logits_rows(_t(logits), temps=_t(temps),
                                  top_ks=_t(top_ks).long(), noise=_t(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generation_is_seeded_per_row(pair, batch):
    _, _, model = pair
    tokens, mask = batch
    kw = dict(prompt_mask=_t(mask), max_new_tokens=NEW, temperature=0.8,
              top_k=5)
    a = tgen.generate(model, _t(tokens).long(),
                      generators=tgen.row_generators(1, 3, "cpu"), **kw)
    b = tgen.generate(model, _t(tokens).long(),
                      generators=tgen.row_generators(1, 3, "cpu"), **kw)
    assert torch.equal(a, b)
    # Row 0 alone draws the same stream as row 0 inside the batch.
    solo = tgen.generate(model, _t(tokens[:1]).long(),
                         generators=tgen.row_generators(1, 1, "cpu"),
                         prompt_mask=_t(mask[:1]), max_new_tokens=NEW,
                         temperature=0.8, top_k=5)
    assert torch.equal(solo[0], a[0])
