"""The PyTorch port's ResNet against the JAX reference on the CPU: the
"SAME" padding of convolutions and max-pools, space-to-depth, logits in
train and eval mode under the three stems, the batch stats a training
forward leaves, and whole classification steps (SGD with and without
Nesterov momentum, AdamW, gradient accumulation with batch stats).

The same numpy inputs and the reference's initial variables (converted
by ``models/convert.state_from_flax``) go through both packages, in f32.
Tolerance: relative L2 1e-4 for logits, stats and weights (f32 rounding
of the same math summed in another order; cuDNN-free CPU convolutions
and XLA's differ in the order of their sums); accuracy and argmax equal.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu.models import create_model as jax_create
from kubeflow_tpu.models.resnet import space_to_depth as jax_s2d
from kubeflow_tpu.train import steps as jsteps
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models import layers, resnet
from kubeflow_tpu_torch.models.convert import state_from_flax
from kubeflow_tpu_torch.train import steps

TOL = 1e-4

# name -> (registry name, overrides, input shape NHWC)
CASES = {
    # cifar stem, BasicBlock, a stride-2 stage with a projection.
    "resnet_tiny": ("resnet_tiny", {}, (4, 16, 16, 3)),
    # Bottleneck blocks, projections, the 7x7/2 stem and the max-pool's
    # asymmetric "SAME" padding (64 -> 32 -> 16, odd windows).
    "resnet50-imagenet": ("resnet50", dict(num_filters=8, num_classes=10),
                          (2, 64, 64, 3)),
    "resnet50-s2d": ("resnet50", dict(num_filters=8, num_classes=10,
                                      stem="space_to_depth"),
                     (2, 64, 64, 3)),
}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.linalg.norm(want)
    if scale == 0:
        return float(np.abs(got).max())
    return float(np.linalg.norm(got - want) / scale)


def _models(case, seed=0):
    name, overrides, shape = CASES[case]
    jm = jax_create(name, **{**overrides, "dtype": jnp.float32})
    variables = jax.device_get(jm.init(
        jax.random.key(seed), jnp.ones(shape, jnp.float32), train=False))
    tm = create_model(name, device="cpu",
                      **{**overrides, "dtype": torch.float32})
    tm.load_state_dict(state_from_flax(variables, tm))
    return jm, variables, tm


def _images(shape, seed=1):
    rs = np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32)


def _labels(n, classes, seed=2):
    return np.random.RandomState(seed).randint(0, classes, n).astype(
        np.int32)


def _hold_state(tm, params, batch_stats, tol=TOL):
    """``tm``'s stats, each, and its weights, as one vector, within ``tol``
    of the reference's tree.  The weights are held together: a norm's
    bias starts at zero, and its gradient under the next norm (which
    removes a shift of its input) is a difference of nearly equal sums,
    so after a few steps that one tensor's relative error measures f32
    cancellation in both packages (up to 6e-4 read on the narrow
    ResNet-50), not the port."""
    want = state_from_flax({"params": params, "batch_stats": batch_stats},
                           tm)
    got = tm.state_dict()
    assert set(got) == set(want)
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * sum(isinstance(m, layers.BatchNorm)
                                 for m in tm.modules())
    for key in stats:
        err = _rel(got[key].numpy(), want[key].numpy())
        assert err <= tol, (key, err)
    weights = [k for k in want if k not in stats]
    flat = lambda d: np.concatenate([d[k].numpy().ravel() for k in weights])
    assert _rel(flat(got), flat(want)) <= tol


# -- padding, pooling, layout ---------------------------------------------


@pytest.mark.parametrize("size,kernel,stride", [
    (56, 3, 2), (57, 3, 2), (112, 3, 2), (112, 4, 1), (7, 1, 2), (8, 7, 2),
    (5, 3, 1), (1, 3, 2)])
def test_same_pads_match_xla(size, kernel, stride):
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert layers.same_pads(size, kernel, stride) == tuple(want[0])


def test_strided_same_conv_pads_asymmetrically_as_flax():
    """A 3x3/2 "SAME" conv on an even size pads (0, 1), not torch's
    (1, 1): the port matches flax and torch's symmetric padding does
    not."""
    x = _images((2, 8, 8, 4))
    conv = fnn.Conv(6, (3, 3), (2, 2), padding="SAME", use_bias=False)
    v = conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x))).transpose(0, 3, 1, 2)
    tconv = layers.Conv2d(4, 6, 3, 2, dtype=torch.float32)
    w = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(
        3, 2, 0, 1).copy())
    tconv.weight.data.copy_(w)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert _rel(tconv(xt).numpy(), want) <= TOL
        assert _rel(F.conv2d(xt, w, None, 2, 1).numpy(), want) > 0.1


@pytest.mark.parametrize("size", [8, 9, 112])
def test_max_pool_same_matches_flax(size):
    x = _images((2, size, size, 3))
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                   padding="SAME")).transpose(0, 3, 1, 2)
    got = layers.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_space_to_depth_matches_reference():
    x = _images((2, 8, 6, 3))
    np.testing.assert_array_equal(
        resnet.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jax_s2d(jnp.asarray(x))))
    with pytest.raises(ValueError, match="divisible"):
        resnet.space_to_depth(torch.zeros(1, 5, 6, 3))


def test_batch_norm_keeps_flax_running_stats():
    """Training normalises by the batch's biased variance and moves the
    running stats by 0.1 toward the batch's mean and biased variance;
    eval normalises by the running stats."""
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 5, 3, 3) * 2 + 1).astype(np.float32)
    bn = layers.BatchNorm(5, dtype=torch.float32)
    bn.reset_parameters(None)
    bn.mean.fill_(0.5)
    bn.var.fill_(2.0)
    xt = torch.from_numpy(x)
    y = bn(xt, train=True)
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))              # biased
    want = (x - mean[:, None, None]) / np.sqrt(var[:, None, None] + 1e-5)
    assert _rel(y.detach().numpy(), want) <= TOL
    assert _rel(bn.mean.numpy(), 0.9 * 0.5 + 0.1 * mean) <= 1e-6
    assert _rel(bn.var.numpy(), 0.9 * 2.0 + 0.1 * var) <= 1e-6
    y_eval = bn(xt, train=False)
    want_eval = ((x - bn.mean.numpy()[:, None, None])
                 / np.sqrt(bn.var.numpy()[:, None, None] + 1e-5))
    assert _rel(y_eval.detach().numpy(), want_eval) <= TOL
    assert set(dict(bn.named_buffers())) == {"mean", "var"}
    assert set(dict(bn.named_parameters())) == {"scale", "bias"}


# -- forwards ---------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_batch_stats_match_reference(case):
    """A training forward: logits and the stats it leaves; then eval with
    those stats (not the initial zeros and ones)."""
    jm, v, tm = _models(case)
    x = _images(CASES[case][2])
    want, new = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    got = tm(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    _hold_state(tm, v["params"], jax.device_get(new["batch_stats"]))
    x2 = _images(CASES[case][2], seed=5)
    want_eval = jm.apply({"params": v["params"], **new}, jnp.asarray(x2),
                         train=False)
    with torch.no_grad():
        before = {k: t.clone() for k, t in tm.state_dict().items()}
        got_eval = tm(torch.from_numpy(x2), train=False)
    assert _rel(got_eval.numpy(), want_eval) <= TOL
    for k, t in tm.state_dict().items():      # eval leaves the stats
        assert torch.equal(t, before[k]), k


def test_registry_configs_match_reference_shapes():
    """Every registered ResNet has the reference's parameter and stat
    tree (names and shapes), at a narrow width."""
    for name in ("resnet18", "resnet34", "resnet50", "resnet101"):
        jm = jax_create(name, num_filters=4, num_classes=3,
                        dtype=jnp.float32)
        v = jax.eval_shape(lambda: jm.init(
            jax.random.key(0), jnp.ones((1, 32, 32, 3)), train=False))
        v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), v)
        tm = create_model(name, device="meta", num_filters=4, num_classes=3)
        state = state_from_flax(v, tm)
        assert set(state) == set(tm.state_dict()), name


# -- train steps ------------------------------------------------------------


def _states(case, tx_jax, tx_port):
    jm, v, tm = _models(case)
    js = jsteps.create_train_state(
        jax.random.key(0), jm, jnp.ones(CASES[case][2], jnp.float32),
        tx_jax, init_kwargs={"train": False})
    js = js.replace(params=v["params"], batch_stats=v["batch_stats"],
                    opt_state=tx_jax.init(v["params"]))
    tm.requires_grad_(True)
    return js, steps.TrainState(tm, tx_port(tm.parameters()))


def _batch(case, i):
    shape = CASES[case][2]
    classes = 10
    return _images(shape, seed=10 + i), _labels(shape[0], classes, seed=20 + i)


OPTIMIZERS = {
    "sgd-momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda p: steps.sgd(p, 0.1, momentum=0.9)),
    "sgd-nesterov": (lambda: optax.sgd(0.1, momentum=0.9, nesterov=True),
                     lambda p: steps.sgd(p, 0.1, momentum=0.9,
                                         nesterov=True)),
    "adamw": (lambda: optax.adamw(1e-3),
              lambda p: steps.adamw(p, 1e-3)),
}


@pytest.mark.parametrize("case,opt", [
    ("resnet_tiny", "sgd-momentum"), ("resnet_tiny", "sgd-nesterov"),
    ("resnet_tiny", "adamw"), ("resnet50-imagenet", "sgd-nesterov")])
def test_classification_steps_match_reference(case, opt):
    """Three steps on three batches: loss and accuracy every step, then
    every weight and stat."""
    make_jax, make_port = OPTIMIZERS[opt]
    js, state = _states(case, make_jax(), make_port)
    jstep = jax.jit(jsteps.make_classification_train_step(
        has_batch_stats=True))
    step = steps.make_classification_train_step(has_batch_stats=True)
    for i in range(3):
        x, y = _batch(case, i)
        js, jm = jstep(js, (jnp.asarray(x), jnp.asarray(y)))
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
        assert m["accuracy"].item() == float(jm["accuracy"])
    assert state.step == 3
    _hold_state(state.module, jax.device_get(js.params),
                jax.device_get(js.batch_stats))


def test_one_step_leaves_the_reference_batch_stats():
    js, state = _states("resnet50-imagenet", optax.sgd(0.1, momentum=0.9),
                        lambda p: steps.sgd(p, 0.1, momentum=0.9))
    x, y = _batch("resnet50-imagenet", 0)
    js, _ = jsteps.make_classification_train_step(has_batch_stats=True)(
        js, (jnp.asarray(x), jnp.asarray(y)))
    state, _ = steps.make_classification_train_step(has_batch_stats=True)(
        state, (torch.from_numpy(x), torch.from_numpy(y)))
    want = state_from_flax({"params": js.params,
                            "batch_stats": js.batch_stats}, state.module)
    assert state.batch_stats
    for key, t in state.batch_stats.items():
        assert key.endswith((".mean", ".var"))
        assert _rel(t.numpy(), want[key].numpy()) <= TOL, key


def test_grad_accum_with_batch_stats_matches_reference():
    """Two microbatches: the mean gradient applied once, the stats chained
    through both microbatches' forwards (the last one's win)."""
    js, state = _states("resnet_tiny", optax.sgd(0.1, momentum=0.9),
                        lambda p: steps.sgd(p, 0.1, momentum=0.9))
    jstep = jax.jit(jsteps.make_grad_accum_step(
        jsteps.make_classification_grad_fn(has_batch_stats=True), 2,
        has_batch_stats=True))
    step = steps.make_grad_accum_step(
        steps.make_classification_grad_fn(has_batch_stats=True), 2,
        has_batch_stats=True)
    for i in range(2):
        x, y = _batch("resnet_tiny", i)
        js, jm = jstep(js, (jnp.asarray(x), jnp.asarray(y)))
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert _rel(m["loss"].item(), float(jm["loss"])) <= 1e-5
        assert m["accuracy"].item() == float(jm["accuracy"])
    _hold_state(state.module, jax.device_get(js.params),
                jax.device_get(js.batch_stats))


def test_has_batch_stats_must_say_what_the_model_has():
    _, _, tm = _models("resnet_tiny")
    tm.requires_grad_(True)
    state = steps.TrainState(tm, steps.sgd(tm.parameters(), 0.1))
    x, y = _batch("resnet_tiny", 0)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(ValueError, match="has_batch_stats=False"):
        steps.make_classification_train_step(has_batch_stats=False)(
            state, batch)
    with pytest.raises(ValueError, match="has_batch_stats=False"):
        steps.make_grad_accum_step(
            steps.make_classification_grad_fn(has_batch_stats=True), 2)(
                state, batch)
    assert state.step == 0
