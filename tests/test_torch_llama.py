"""PyTorch port Llama (kubeflow_tpu_torch.models) against the JAX reference:
parameter conversion, full-sequence logits, RoPE pairing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.layers import apply_rope as jax_apply_rope
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import expected_leaves, params_from_jax
from kubeflow_tpu_torch.models.layers import apply_rope


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, numpy param tree, port model) for
    llama_debug (GQA 4 q heads over 2 kv heads, f32)."""
    jm = JaxLlama(JAX_CONFIGS["llama_debug"])
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    tree = jax.device_get(params)
    model = create_model("llama_debug", device="cpu")
    model.load_state_dict(params_from_jax(tree, model.cfg))
    return jm, params, tree, model


def test_params_from_jax_maps_every_leaf_with_its_shape(pair):
    _, _, tree, model = pair
    state = params_from_jax(tree, model.cfg)
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name
    # GQA: 4 q heads, 2 kv heads of head_dim 16 over dim 64.
    assert state["layers.0.attn.q_proj.weight"].shape == (64, 64)
    assert state["layers.0.attn.k_proj.weight"].shape == (32, 64)
    assert state["lm_head.weight"].dtype == torch.float32
    assert len(expected_leaves(model.cfg)) == len(state)


def test_params_from_jax_raises_on_missing_or_extra_leaf(pair):
    _, _, tree, model = pair
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_jax(missing, model.cfg)
    extra = dict(tree, bonus={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="bonus"):
        params_from_jax(extra, model.cfg)


def test_params_from_jax_keeps_bf16_dense_and_f32_head():
    import dataclasses

    cfg = dataclasses.replace(JAX_CONFIGS["llama_debug"],
                              dtype=jnp.bfloat16)
    jm = JaxLlama(cfg)
    params = jm.init(jax.random.key(1), jnp.ones((1, 4), jnp.int32))["params"]
    model = create_model("llama_debug", device="cpu", dtype=torch.bfloat16)
    state = params_from_jax(jax.device_get(params), model.cfg)
    assert state["layers.1.mlp.up_proj.weight"].dtype == torch.bfloat16
    assert state["embed.embedding"].dtype == torch.bfloat16
    assert state["final_norm.scale"].dtype == torch.float32
    assert state["lm_head.weight"].dtype == torch.float32


@pytest.mark.parametrize("packed", [False, True])
def test_full_sequence_logits_match_reference(pair, packed):
    jm, params, _, model = pair
    rs = np.random.RandomState(3)
    tokens = rs.randint(0, 256, size=(2, 24))
    seg = None
    if packed:
        seg = np.repeat(np.array([[1, 2, 3], [1, 1, 2]]), 8, axis=1)
    want = jm.apply({"params": params}, jnp.asarray(tokens),
                    segment_ids=None if seg is None else jnp.asarray(seg))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens),
                    segment_ids=None if seg is None
                    else torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_rope_is_half_split_like_reference():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 5, 3, 16).astype(np.float32)
    pos = rs.randint(0, 100, size=(2, 5))
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=5e5)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=5e5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # Half-split: dim i pairs with i + d/2, so rotating a vector that is
    # nonzero only in dim 0 leaves dims other than 0 and 8 at zero.
    e0 = torch.zeros(1, 1, 1, 16)
    e0[..., 0] = 1.0
    r = apply_rope(e0, torch.tensor([[3]]))
    assert torch.count_nonzero(r[..., [i for i in range(16)
                                       if i not in (0, 8)]]) == 0


def test_model_refuses_moe_and_missing_card():
    """The MoE configs build on the CPU (they were refused until the MoE
    MLP was ported; the name is kept); a missing card still raises."""
    moe = create_model("mixtral_debug", device="cpu")
    assert moe.cfg.n_experts == 4 and moe.layers[0].moe
    assert moe.layers[0].mlp.w_gate.shape == (4, 64, 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            create_model("llama_debug")


def test_seeded_init_follows_flax_schemes():
    model = create_model("llama_debug", device="cpu", vocab_size=4096,
                         dim=256, ffn_dim=512, n_heads=4, n_kv_heads=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    q = model.layers[0].attn.q_proj.weight
    emb = model.embed.embedding
    # lecun_normal: truncated at 2 std of a unit-variance-over-fan_in law.
    assert abs(q.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert q.abs().max().item() <= 2 * 256 ** -0.5 / 0.87962566103423978
    assert abs(emb.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert torch.equal(model.final_norm.scale, torch.ones(256))


@pytest.mark.parametrize("first", [12, 5])
def test_second_prefill_chunk_at_a_cache_index_matches_reference(pair,
                                                                  first):
    """A multi-token step at cache index > 0 (a later prefill chunk) runs
    end-aligned causal attention over the written slots; the reference
    attends over its whole cache with the causal and unwritten-slot bias
    of ``_update_cache``.  Two right-padded rows of 20 and 13 tokens, cut
    into two chunks, into a cache longer than the prompt: every position
    of both chunks agrees within 1e-4."""
    jm, params, _, model = pair
    lens, cache_len = (20, 13), 24
    rs = np.random.RandomState(7)
    mask = np.arange(max(lens))[None] < np.array(lens)[:, None]
    tokens = np.where(mask, rs.randint(0, 256, size=mask.shape), 0)
    positions = np.maximum(np.cumsum(mask, axis=-1) - 1, 0)
    chunks = [slice(0, first), slice(first, max(lens))]
    want, variables = [], {"params": params}
    for c in chunks:
        logits, state = jm.apply(
            variables, jnp.asarray(tokens[:, c]),
            positions=jnp.asarray(positions[:, c]), decode=True,
            cache_len=cache_len, mutable=["cache"])
        variables = {"params": params, "cache": state["cache"]}
        want.append(np.asarray(logits))
    cache = model.new_cache(len(lens), cache_len)
    with torch.inference_mode():
        for c, w in zip(chunks, want):
            got = model(torch.from_numpy(tokens[:, c]).long(),
                        positions=torch.from_numpy(positions[:, c]),
                        cache=cache)
            np.testing.assert_allclose(got.numpy(), w, atol=1e-4, rtol=0)
    assert cache.index == max(lens)
