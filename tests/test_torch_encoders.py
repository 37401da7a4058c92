"""The PyTorch port's encoders (ViT, BERT) and their building blocks
against the JAX reference on the CPU: the biased Dense, the tanh GELU
MLP, flax's LayerNorm, the encoder attention and its route for a biased
call, logits in train and eval mode (BERT with and without a padding
mask), three classification steps with SGD and AdamW, and dropout by its
statistics.

The same numpy inputs and the reference's initial parameters (converted
by ``models/convert.state_from_flax``) go through both packages, in f32.
Tolerance: relative L2 1e-4 for outputs and weights (f32 rounding of the
same math summed in another order); accuracy and argmax equal.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import create_model as jax_create
from kubeflow_tpu.models.layers import Attention as JaxAttention
from kubeflow_tpu.models.layers import Mlp as JaxMlp
from kubeflow_tpu.train import steps as jsteps
from kubeflow_tpu_torch.models import convert, create_model, layers
from kubeflow_tpu_torch.models.convert import state_from_flax
from kubeflow_tpu_torch.train import steps

TOL = 1e-4

# name -> (input shape, token vocabulary or None for images)
MODELS = {"vit_debug": ((2, 32, 32, 3), None),
          "bert_debug": ((2, 16), 128)}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(name, seed=1):
    shape, vocab = MODELS[name]
    rs = np.random.RandomState(seed)
    if vocab is None:
        return rs.randn(*shape).astype(np.float32)
    return rs.randint(0, vocab, shape).astype(np.int32)


def _mask():
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    return mask


def _models(name, seed=0):
    jm = jax_create(name)
    x = _inputs(name)
    v = jax.device_get(jm.init(jax.random.key(seed), jnp.asarray(x),
                               train=False))
    tm = create_model(name, device="cpu")
    tm.load_state_dict(state_from_flax(v, tm))
    return jm, v, tm


# -- building blocks --------------------------------------------------------


def test_biased_linear_and_gelu_mlp_match_flax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 8).astype(np.float32)
    jm = JaxMlp(hidden_dim=16, dtype=jnp.float32)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    # Non-zero biases, so the bias path is exercised.
    v = jax.tree_util.tree_map(
        lambda a: a + 0.1 if a.ndim == 1 else a, jax.device_get(v))
    tm = layers.Mlp(8, 16, dtype=torch.float32)
    tm.load_state_dict(state_from_flax(v, tm))
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        # flax's nn.gelu is the tanh approximation, not torch's default.
        exact = tm.fc2(torch.nn.functional.gelu(tm.fc1(torch.from_numpy(x))))
    err = _rel(got.numpy(), want)
    assert err <= TOL
    assert _rel(exact.numpy(), want) > 100 * err
    assert tm.fc1.bias is not None and layers.Linear(
        8, 4, dtype=torch.float32).bias is None


def test_layer_norm_matches_flax_with_its_epsilon():
    rs = np.random.RandomState(1)
    # A small spread: eps 1e-6 and torch's 1e-5 give other outputs.
    x = (rs.randn(4, 6, 32) * 3e-3).astype(np.float32)
    ln = fnn.LayerNorm(dtype=jnp.float32)
    v = ln.init(jax.random.key(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: a + 0.5, jax.device_get(v))
    tm = layers.LayerNorm(32, dtype=torch.float32)
    tm.load_state_dict(state_from_flax(v, tm))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, ln.apply(v, jnp.asarray(x))) <= TOL
    torch_default = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (32,), tm.scale, tm.bias).detach().numpy()
    assert _rel(torch_default, got) > 10 * TOL


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_attention_matches_reference(masked):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 16, 32).astype(np.float32)
    bias = None
    if masked:
        bias = ((1.0 - _mask()[:, None, None, :]) * -1e30).astype(np.float32)
    ja = JaxAttention(num_heads=4, dtype=jnp.float32)
    v = jax.device_get(ja.init(jax.random.key(0), jnp.asarray(x)))
    want = ja.apply(v, jnp.asarray(x), mask_bias=None if bias is None
                    else jnp.asarray(bias))
    ta = layers.EncoderAttention(32, 4, dtype=torch.float32)
    ta.load_state_dict(state_from_flax(v, ta))
    with torch.no_grad():
        got = ta(torch.from_numpy(x), mask_bias=None if bias is None
                 else torch.from_numpy(bias))
    assert _rel(got.numpy(), want) <= TOL


def test_biased_attention_names_the_plain_route():
    """A biased call takes impl="plain" whatever the module's route; an
    unbiased one keeps it ("kernel" refuses CPU tensors)."""
    ta = layers.EncoderAttention(32, 4, dtype=torch.float32, impl="kernel")
    ta.apply(lambda m: m.reset_parameters(torch.Generator().manual_seed(0))
             if isinstance(m, layers.Linear) else None)
    x = torch.randn(2, 16, 32)
    bias = torch.zeros(2, 1, 1, 16)
    with torch.no_grad():
        assert ta(x, mask_bias=bias).shape == x.shape
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ta(x)


def test_dropout_keeps_the_expected_share_from_its_generator():
    """Dropout cannot repeat JAX's random bits: held by its statistics.
    Kept elements are scaled by 1 / (1 - rate), the kept share is within
    5 sigma of 1 - rate, the same generator state repeats the mask, and
    a rate without a generator raises."""
    x = torch.ones(200_000)
    rate = 0.1
    y = layers.dropout(x, rate, torch.Generator().manual_seed(3))
    kept = (y != 0).double().mean().item()
    sigma = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(kept - (1 - rate)) < 5 * sigma
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - rate)))
    assert torch.equal(y, layers.dropout(x, rate,
                                         torch.Generator().manual_seed(3)))
    assert layers.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        layers.dropout(x, rate, None)


@pytest.mark.parametrize("name", list(MODELS))
def test_dropout_in_a_model_draws_only_in_training(name):
    tm = create_model(name, device="cpu", dropout=0.1)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_inputs(name))
    with torch.no_grad():
        a = tm(x, train=True, generator=torch.Generator().manual_seed(1))
        b = tm(x, train=True, generator=torch.Generator().manual_seed(1))
        c = tm(x, train=True, generator=torch.Generator().manual_seed(2))
        e1, e2 = tm(x, train=False), tm(x, train=False)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert torch.equal(e1, e2)
        with pytest.raises(ValueError, match="needs a torch.Generator"):
            tm(x, train=True)


# -- forwards ---------------------------------------------------------------


@pytest.mark.parametrize("name,masked", [
    ("vit_debug", False), ("bert_debug", False), ("bert_debug", True)])
@pytest.mark.parametrize("train", [False, True])
def test_logits_match_reference(name, masked, train):
    jm, v, tm = _models(name)
    x = _inputs(name, seed=3)
    kw_j, kw_t = {}, {}
    if masked:
        kw_j["attention_mask"] = jnp.asarray(_mask())
        kw_t["attention_mask"] = torch.from_numpy(_mask())
    want = jm.apply(v, jnp.asarray(x), train=train, **kw_j)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train, **kw_t)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


def test_bert_all_ones_mask_equals_no_mask_and_padding_matters():
    _, _, tm = _models("bert_debug")
    x = torch.from_numpy(_inputs("bert_debug"))
    with torch.no_grad():
        free = tm(x, train=False)
        ones = tm(x, attention_mask=torch.ones(2, 16, dtype=torch.int32),
                  train=False)
        padded = tm(x, attention_mask=torch.from_numpy(_mask()),
                    train=False)
    assert _rel(ones.numpy(), free.numpy()) <= TOL
    assert torch.equal(padded[0], ones[0]) or _rel(
        padded[0].numpy(), ones[0].numpy()) <= TOL
    assert _rel(padded[1].numpy(), ones[1].numpy()) > TOL


def test_registry_configs_match_reference_shapes():
    """Every registered ViT and BERT has the reference's parameter tree:
    the full-width configs on the meta device, each leaf's port key and
    torch-layout shape (zero-stride views, nothing allocated)."""
    for name, shape, dtype in (("vit_b16", (1, 224, 224, 3), jnp.float32),
                               ("vit_s16", (1, 224, 224, 3), jnp.float32),
                               ("vit_l16", (1, 224, 224, 3), jnp.float32),
                               ("bert_base", (1, 8), jnp.int32),
                               ("bert_large", (1, 8), jnp.int32)):
        jm = jax_create(name)
        v = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                           jnp.ones(shape, dtype),
                                           train=False))
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                v["params"])[0]:
            p = "/".join(k.key for k in path)
            view = np.broadcast_to(np.float32(0), leaf.shape)
            want[convert._flax_key(p)] = convert._flax_array(p, view).shape
        tm = create_model(name, device="meta")
        got = {k: tuple(t.shape) for k, t in tm.state_dict().items()}
        assert got == want, name


# -- train steps ------------------------------------------------------------


def _labels(seed):
    return np.random.RandomState(seed).randint(0, 2, 2).astype(np.int32)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("opt", ["sgd-nesterov", "adamw"])
def test_classification_steps_match_reference(name, opt):
    """Three steps: loss and accuracy every step, then every weight.  The
    step passes no attention mask, as the reference's does."""
    jm, v, tm = _models(name)
    tx, make = {
        "sgd-nesterov": (optax.sgd(0.1, momentum=0.9, nesterov=True),
                         lambda p: steps.sgd(p, 0.1, momentum=0.9,
                                             nesterov=True)),
        "adamw": (optax.adamw(1e-3), lambda p: steps.adamw(p, 1e-3)),
    }[opt]
    js = jsteps.create_train_state(jax.random.key(0), jm,
                                   jnp.asarray(_inputs(name)), tx,
                                   init_kwargs={"train": False})
    js = js.replace(params=v["params"], opt_state=tx.init(v["params"]))
    tm.requires_grad_(True)
    state = steps.TrainState(tm, make(tm.parameters()))
    assert state.batch_stats == {}
    jstep = jax.jit(jsteps.make_classification_train_step(
        has_batch_stats=False))
    step = steps.make_classification_train_step(has_batch_stats=False)
    for i in range(3):
        x, y = _inputs(name, seed=10 + i), _labels(20 + i)
        js, jm_ = jstep(js, (jnp.asarray(x), jnp.asarray(y)))
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert _rel(m["loss"].item(), float(jm_["loss"])) <= 1e-5
        assert m["accuracy"].item() == float(jm_["accuracy"])
    want = state_from_flax({"params": jax.device_get(js.params)}, tm)
    got = tm.state_dict()
    flat = lambda d: np.concatenate([d[k].detach().numpy().ravel()
                                     for k in sorted(want)])
    assert _rel(flat(got), flat(want)) <= TOL
