"""Every family's tensor-parallel compute as its shards, and batch
statistics over the data axes, in the port (``models/layers.py``,
``models/moe.py``, ``models/t5.py``, ``train/steps.py``'s
vocabulary-parallel loss, ``parallel/train.py``, ``parallel/sharding.py``)
against the JAX package and the port's own one-process step, on the CPU
over gloo (``tests/test_torch_multirank.py``).

One sharded step a run: ResNet at dp=2 (and 2 accumulated microbatches,
and beside tp=2) against the reference's one-device step; ViT, BERT with
padded rows and T5 at tp=2 and fsdp=2,tp=2 against the reference's loss
and the port's one-process step; Llama at tp=2 (plain, the chunked head,
packed rows) and Mixtral at tp=2 and ep=2,tp=2 against the port's
one-process step.  Tolerances: the loss within 1e-4, updated parameters
and batch stats within 1e-5 (f32 sums in another order), every process's
batch stats bit-equal.  The biases are drawn nonzero, so a bias added
once a rank, or sliced wrongly, shows."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dataclasses

from kubeflow_tpu.models import create_model as jax_create
from kubeflow_tpu.train import create_train_state
from kubeflow_tpu.train import make_lm_train_step as jax_step
from kubeflow_tpu.train import steps as jsteps
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import params_from_jax, state_from_flax
from kubeflow_tpu_torch.models.layers import Mlp
from kubeflow_tpu_torch.models.llama import CONFIGS
from kubeflow_tpu_torch.train import steps
from test_torch_multirank import World, family_grad_fn, family_state
from test_torch_parallel import DEBUG, _segments, _setup

LOSS_TOL, PARAM_TOL, STATS_TOL = 1e-4, 1e-5, 1e-5
ROWS = 4


def _perturbed(tree, seed=7):
    """The reference's params with every bias drawn nonzero (they start
    at zero)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (np.asarray(x) + 0.1 * rs.randn(*x.shape).astype(
            np.float32)) if str(path[-1].key) == "bias" else np.asarray(x),
        jax.device_get(tree))


def _port_state(name, variables, **overrides):
    tm = create_model(name, device="cpu", **overrides)
    return {k: v.numpy() for k, v in state_from_flax(variables, tm).items()}


def _resnet():
    """resnet_tiny from the reference's init (biases perturbed), 8 images
    of 16 px, and the reference's train state (SGD 0.1, momentum 0.9)."""
    jm = jax_create("resnet_tiny")
    rs = np.random.RandomState(1)
    images = rs.randn(8, 16, 16, 3).astype(np.float32)
    labels = rs.randint(0, 10, 8).astype(np.int32)
    tx = optax.sgd(0.1, momentum=0.9)
    js = jsteps.create_train_state(jax.random.key(0), jm,
                                   jnp.asarray(images), tx,
                                   init_kwargs={"train": False})
    params = _perturbed(js.params)
    js = js.replace(params=params, opt_state=tx.init(params))
    state = _port_state("resnet_tiny", {
        "params": params, "batch_stats": jax.device_get(js.batch_stats)})
    return js, state, images, labels


def _reference_resnet(js, images, labels, n_accum):
    """The reference's one-device step (with ``n_accum`` microbatches) on
    the batch: its loss, then params and stats in the port's names."""
    if n_accum > 1:
        step = jsteps.make_grad_accum_step(
            jsteps.make_classification_grad_fn(has_batch_stats=True),
            n_accum, has_batch_stats=True)
    else:
        step = jsteps.make_classification_train_step(has_batch_stats=True)
    js, metrics = jax.jit(step)(js, (jnp.asarray(images),
                                     jnp.asarray(labels)))
    want = _port_state("resnet_tiny", jax.device_get(
        {"params": js.params, "batch_stats": js.batch_stats}))
    return float(metrics["loss"]), want


def _microbatch_order(x, n_data, n_accum):
    """The rows of ``x`` in the order whose contiguous microbatch i is
    every data process's i-th chunk of its rows (the port's sharded
    step's microbatch i): process r holds rows [r n / P, (r + 1) n / P)."""
    parts = [np.split(p, n_accum) for p in np.split(x, n_data)]
    return np.concatenate([parts[r][i] for i in range(n_accum)
                           for r in range(n_data)])


def _check_resnet(results, key, js, images, labels, n_data, n_accum=1):
    loss, want = _reference_resnet(
        js, _microbatch_order(images, n_data, n_accum),
        _microbatch_order(labels, n_data, n_accum), n_accum)
    lead = results[0][key]
    assert abs(lead["loss"] - loss) < LOSS_TOL, key
    for r in results:
        assert r[key]["loss"] == lead["loss"]
        for name, got in r[key]["params"].items():
            assert np.abs(got - want[name]).max() < PARAM_TOL, (key, name)
        assert set(r[key]["stats"]) == {k for k in want
                                        if k.endswith((".mean", ".var"))}
        for name, got in r[key]["stats"].items():
            assert np.abs(got - want[name]).max() < STATS_TOL, (key, name)
            # Every process normalised by the same global statistics.
            np.testing.assert_array_equal(got, lead["stats"][name])


def test_batch_statistics_over_the_data_axes_match_the_reference(tmp_path):
    """resnet_tiny at dp=2, and with 2 accumulated microbatches (each
    microbatch's statistics global over its rows on both processes):
    loss, parameters and batch stats against the reference's one-device
    step, the stats bit-equal on both processes."""
    with World("tp_families", 2, tmp_path) as world:
        js, state, images, labels = _resnet()
        results = world.result({
            "families": {"resnet": {"state": state}},
            "batches": {"images": (images, labels)},
            "runs": [("dp2", "resnet", "images", dict(dp=2), {}),
                     ("dp2-accum", "resnet", "images", dict(dp=2),
                      {"n_accum": 2})]})
    _check_resnet(results, "dp2", js, images, labels, 2)
    _check_resnet(results, "dp2-accum", js, images, labels, 2, n_accum=2)


# -- the encoders, T5, Llama and Mixtral under tp -----------------------------


def _encoder(name, seed=0):
    """(port state, batch, the reference's loss on it) for vit_debug and
    bert_debug (padded rows), from the reference's init with its biases
    perturbed."""
    jm = jax_create(name)
    rs = np.random.RandomState(3)
    labels = rs.randint(0, 10 if name == "vit_debug" else 2,
                        ROWS).astype(np.int32)
    if name == "vit_debug":
        x = rs.randn(ROWS, 32, 32, 3).astype(np.float32)
        kw = {}
    else:
        x = rs.randint(0, 128, (ROWS, 16)).astype(np.int32)
        mask = np.ones((ROWS, 16), np.int32)
        mask[1, 11:] = 0
        mask[2, 5:] = 0
        kw = {"attention_mask": jnp.asarray(mask)}
    v = jax.jit(jm.init, static_argnames="train")(
        jax.random.key(seed), jnp.asarray(x[:1]), train=False)
    params = _perturbed(v["params"])
    logits = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x),
                                        train=True, **kw))(params)
    loss = float(optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(labels)).mean())
    batch = (x, labels) if name == "vit_debug" else (x, labels, mask)
    return _port_state(name, {"params": params}), batch, loss


def _t5():
    """t5_debug's port state, a (source, target, source mask) batch and
    the reference's teacher-forced loss on it (``tests/test_t5.py``)."""
    jm = jax_create("t5_debug")
    rs = np.random.RandomState(4)
    src = rs.randint(2, 128, (ROWS, 12)).astype(np.int32)
    tgt = rs.randint(2, 128, (ROWS, 6)).astype(np.int32)
    mask = np.ones((ROWS, 12), bool)
    mask[1, 7:] = False
    v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(src[:1]),
                         jnp.asarray(tgt[:1]))
    logits = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(src), jnp.asarray(tgt),
        source_mask=jnp.asarray(mask)))(v["params"])
    labels = jnp.roll(jnp.asarray(tgt), -1, axis=1)
    loss = float(optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1], labels[:, :-1]).mean())
    return (_port_state("t5_debug", jax.device_get(v)), (src, tgt, mask),
            loss)


def _mixtral():
    """mixtral_debug from the reference's init (f32), its train state and
    4 rows of 32 tokens."""
    jm = jax_create("mixtral_debug", max_seq_len=64)
    tokens = np.random.RandomState(5).randint(0, 256, (ROWS, 32))
    js = create_train_state(jax.random.key(3), jm, tokens, optax.adamw(1e-3))
    cfg = dataclasses.replace(CONFIGS["mixtral_debug"], max_seq_len=64)
    params = {k: v.numpy() for k, v in params_from_jax(
        jax.device_get(js.params), cfg, param_dtype=torch.float32).items()}
    return params, tokens, js


def _reference_loss(js, batch, opts):
    """The reference's LM step's loss on ``batch`` with the run's
    options."""
    _, metrics = jax.jit(jax_step(**opts))(js, batch)
    return float(metrics["loss"])


def _loss_key(family, batch, opts):
    return family, batch, tuple(sorted(opts.items()))


def _one_step(family, fam, batch, opts):
    """The port's one-process step: its loss and updated parameters."""
    opts = dict(opts)
    n_accum = opts.pop("n_accum", 1)
    state = family_state(family, fam["state"], fam.get("overrides"))
    grad_fn = family_grad_fn(family, opts)
    batch = tuple(torch.from_numpy(np.array(x)) for x in batch)
    batch = batch if len(batch) > 1 else batch[0]
    if n_accum > 1:
        state, metrics = steps.make_grad_accum_step(grad_fn, n_accum)(
            state, batch)
    else:
        grads, metrics = grad_fn(state, batch)
        state.apply_gradients(grads)
    return float(metrics["loss"]), {
        k: p.detach().numpy() for k, p in state.module.named_parameters()}


def _families():
    """Every family's state and batches, and the reference's losses."""
    jllama, tokens, llama = _setup()
    vit, vit_batch, vit_loss = _encoder("vit_debug")
    bert, bert_batch, bert_loss = _encoder("bert_debug")
    t5, t5_batch, t5_loss = _t5()
    mixtral, mixtral_tokens, jmixtral = _mixtral()
    families = {
        "vit": {"state": vit}, "bert": {"state": bert}, "t5": {"state": t5},
        "llama": {"state": llama,
                  "overrides": dict(DEBUG, param_dtype=torch.float32)},
        "mixtral": {"state": mixtral,
                    "overrides": dict(param_dtype=torch.float32,
                                      max_seq_len=64)}}
    batches = {"vit": vit_batch, "bert": bert_batch, "t5": t5_batch,
               "tokens": (tokens,), "packed": (tokens, _segments()),
               "mixtral": (mixtral_tokens,)}
    losses = {_loss_key(f, f, {}): loss for f, loss in (
        ("vit", vit_loss), ("bert", bert_loss), ("t5", t5_loss))}
    # The reference's LM step on the same tokens (and segments).
    for family, batch, opts in TP2 + EP2_TP2:
        if family in ("llama", "mixtral"):
            js = jllama if family == "llama" else jmixtral
            x = batches[batch]
            losses[_loss_key(family, batch, opts)] = _reference_loss(
                js, x if len(x) > 1 else x[0], opts)
    return families, batches, losses


def _runs(axes, families):
    return [(f"{fam}-{batch}-{','.join(axes)}-{i}", fam, batch, axes, opts)
            for i, (fam, batch, opts) in enumerate(families)]


TP2 = [("vit", "vit", {}), ("bert", "bert", {}), ("t5", "t5", {}),
       ("llama", "tokens", {}), ("llama", "tokens", {"ce_chunk": 8}),
       ("llama", "packed", {}),
       ("mixtral", "mixtral", {"aux_loss_weight": 0.01})]
FSDP2_TP2 = [("vit", "vit", {}), ("bert", "bert", {}), ("t5", "t5", {})]
# Without the aux loss: over a data axis (ep) each process's aux loss is
# its rows' (the share-weighted sum of per-process losses, not the global
# batch's; ROADMAP.md Queue C), so only tp=2 holds it to one process.
EP2_TP2 = [("mixtral", "mixtral", {})]


def _check_runs(results, runs, families, batches, losses):
    for key, family, batch, axes, opts in runs:
        lead = results[0][key]
        ref = losses[_loss_key(family, batch, opts)]
        assert abs(lead["loss"] - ref) < LOSS_TOL, key
        loss, one = _one_step(family, families[family], batches[batch],
                              opts)
        assert abs(lead["loss"] - loss) < LOSS_TOL, key
        for r in results:
            assert r[key]["loss"] == lead["loss"], key
            assert set(r[key]["params"]) == set(one), key
            for name, want in one.items():
                assert np.abs(r[key]["params"][name] - want).max() \
                    < PARAM_TOL, (key, name)
            # The step gathered nothing over tp.
            assert not [n for n, g in r[key]["gather"].items()
                        if "tp" in g], key


def test_tp_steps_match_the_reference_and_one_process(tmp_path):
    """World 2, tp=2: ViT, BERT (padded rows), T5, Llama (plain, the
    chunked head, packed rows) and Mixtral (with its aux loss), each
    computed as its tp shards (heads, MLP columns, vocabulary, experts'
    ffn columns).  World 4: ViT, BERT and T5 at fsdp=2,tp=2; Mixtral at
    ep=2,tp=2 (its experts split over ep and their ffn columns over tp);
    ResNet at dp=2,tp=2, whose statistics are over dp only (tp ranks hold
    the same rows) and whose head's classes split over tp.  The loss
    against the reference's and the port's one-process step, the updated
    parameters against the port's, and no gather over tp in any step.
    (One test for both worlds: the inputs and references are built
    once, while both worlds start.)"""
    with World("tp_families", 2, tmp_path) as two, \
            World("tp_families", 4, tmp_path) as four:
        families, batches, losses = _families()
        js, resnet, images, labels = _resnet()
        runs2 = _runs(dict(tp=2), TP2)
        results2 = two.result({"families": families, "batches": batches,
                               "runs": runs2})
        families["resnet"] = {"state": resnet}
        batches["images"] = (images, labels)
        runs4 = (_runs(dict(fsdp=2, tp=2), FSDP2_TP2)
                 + _runs(dict(ep=2, tp=2), EP2_TP2))
        results4 = four.result({
            "families": families, "batches": batches,
            "runs": runs4 + [("resnet", "resnet", "images",
                              dict(dp=2, tp=2), {})]})
    _check_runs(results2, runs2, families, batches, losses)
    _check_runs(results4, runs4, families, batches, losses)
    _check_resnet(results4, "resnet", js, images, labels, 2)
    assert results4[0]["resnet"]["gather"]["head.weight"] == ()


def test_served_families_gather_nothing_over_tp(tmp_path):
    """Every family built for serving by ``shard_for_serving`` under
    fsdp=2,tp=2: no gather-at-use step runs over tp (every tp split is
    computed as its shard), and the fsdp splits are gathered at use."""
    with World("tp_families", 4, tmp_path) as world:
        results = world.result({"walk": "fsdp=2,tp=2"})
    for r in results:
        for name, found in r["walk"].items():
            assert found, name
            assert all(axes == ["fsdp"] for axes in found.values()), (
                name, found)
    walk = results[0]["walk"]
    # The tp-split parameters that are also split over fsdp: the head and
    # the embedding are among them, gathered over fsdp alone.
    assert "lm_head.weight" in walk["llama_debug"]
    assert "embed.embedding" in walk["t5_debug"]
    assert "layers.0.mlp.w_gate" in walk["mixtral_debug"]
    assert "head.weight" in walk["resnet_tiny"]


def test_a_replicated_bias_used_as_a_slice_gets_its_whole_gradient(
        tmp_path):
    """An ``Mlp`` at tp=4: ``fc1``'s replicated bias enters as each rank's
    slice and ``fc2``'s after the sum over tp.  Every rank's output and
    both biases' gradients equal the whole layer's (the slice's gradient
    summed over tp), the weights' gathered gradients too."""
    rs = np.random.RandomState(8)
    params = {"fc1.weight": rs.randn(16, 8), "fc1.bias": rs.randn(16),
              "fc2.weight": rs.randn(8, 16), "fc2.bias": rs.randn(8)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rs.randn(2, 3, 8).astype(np.float32)
    with World("tp_families", 4, tmp_path) as world:
        whole = Mlp(8, 16, dtype=torch.float32)
        for name, v in params.items():
            mod, attr = name.split(".")
            setattr(getattr(whole, mod), attr,
                    torch.nn.Parameter(torch.from_numpy(v)))
        y = whole(torch.from_numpy(x))
        want = dict(zip(params, torch.autograd.grad((y ** 2).sum(), [
            getattr(getattr(whole, n.split(".")[0]), n.split(".")[1])
            for n in params])))
        results = world.result({"bias": {"params": params, "x": x}})
    for r in results:
        np.testing.assert_allclose(r["bias"]["y"], y.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
        for name, g in r["bias"]["grads"].items():
            np.testing.assert_allclose(g, want[name].numpy(), atol=1e-4,
                                       rtol=1e-5, err_msg=name)


class _TPMesh:
    """A mesh with only a tp axis of ``tp`` ranks, seen from rank 0, whose
    groups are ``group``, a ``VirtualGroup`` (what ``sharding.tp_shard``
    and ``layout_for`` read)."""

    mesh_dim_names = ("pp", "dp", "fsdp", "ep", "tp", "sp")

    def __init__(self, tp):
        from kubeflow_tpu_torch.parallel import sharding

        self.tp = tp
        self.group = sharding.VirtualGroup()

    def size(self, i):
        return self.tp if self.mesh_dim_names[i] == "tp" else 1

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return self.group


@pytest.mark.parametrize("case", ["heads", "vocabulary"])
def test_a_tp_that_does_not_divide_raises(case):
    """tp=8 splits a ViT-B attention's 768 q rows into whole rows but not
    its 12 heads: the layer raises, as a dense Llama's does.  BERT-base's
    30522-token vocabulary does not split over 4: the rules' placement
    raises, as the reference's does."""
    from kubeflow_tpu_torch.models.layers import EncoderAttention
    from kubeflow_tpu_torch.parallel import sharding
    from kubeflow_tpu_torch.parallel.context import global_mesh

    if case == "vocabulary":
        with pytest.raises(ValueError, match="does not divide"):
            sharding.layout_for("tok_embed.embedding", (30522, 768),
                                sharding.bert_rules(), _TPMesh(4))
        return
    attn = EncoderAttention(768, 12, dtype=torch.float32)
    for lin in (attn.q_proj, attn.k_proj, attn.v_proj):
        lin.weight = torch.nn.Parameter(torch.zeros(96, 768),
                                        requires_grad=False)
    with global_mesh(_TPMesh(8)), pytest.raises(ValueError,
                                                match="must divide"):
        attn(torch.zeros(1, 2, 768))


def test_a_tp_shard_on_a_mesh_without_a_tp_group_raises():
    """A layer holding a tp shard under a mesh whose ``get_group`` gives
    no tp group raises instead of skipping the collectives (partial sums
    with no error); a ``VirtualGroup`` runs this rank's part alone."""
    from kubeflow_tpu_torch.models.layers import Linear, head_logits
    from kubeflow_tpu_torch.parallel import sharding
    from kubeflow_tpu_torch.parallel.context import global_mesh

    head = Linear(8, 4, dtype=torch.float32)
    head.weight = torch.nn.Parameter(torch.ones(2, 8), requires_grad=False)
    x = torch.ones(1, 8)
    mesh = _TPMesh(2)
    mesh.group = None
    with global_mesh(mesh), pytest.raises(RuntimeError, match="no tp"):
        head_logits(head, x)
    with global_mesh(_TPMesh(2)):
        assert isinstance(head.column_shard().group, sharding.VirtualGroup)
        assert head_logits(head, x).shape == (1, 2)
