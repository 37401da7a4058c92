"""The port's pipeline (``kubeflow_tpu_torch/parallel/pipeline.py``) on the
CPU over gloo: GPipe and the interleaved schedule against the sequential
application of the stages and its gradients, against the JAX package's
``pipeline_apply`` on the same numpy inputs, and the reference's
rejections (``tests/test_parallel_extra.py:107-240``)."""
import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kubeflow_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from kubeflow_tpu_torch.parallel.pipeline import stack_stage_params
from test_torch_multirank import _mlp_stage, run_world

TOL = 1e-4


def _per_stage(seed, n, d, hidden):
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.standard_normal((d, hidden)) / np.sqrt(d)).astype(
                 np.float32),
             "b1": (0.1 * rng.standard_normal(hidden)).astype(np.float32),
             "w2": (rng.standard_normal((hidden, d)) / np.sqrt(hidden)
                    ).astype(np.float32),
             "b2": (0.1 * rng.standard_normal(d)).astype(np.float32)}
            for _ in range(n)]


def _stacked(per_stage):
    return {k: np.stack([p[k] for p in per_stage]) for k in per_stage[0]}


def _sequential(per_stage, x, grad=False):
    """The stages applied in order, in torch: y, and with ``grad`` the
    gradients of mean(y^2) by stacked leaf."""
    params = [{k: torch.from_numpy(v).requires_grad_(grad)
               for k, v in p.items()} for p in per_stage]
    y = torch.from_numpy(x)
    for p in params:
        y = _mlp_stage(p, y)
    if not grad:
        return y.detach().numpy(), None
    leaves = [p[k] for p in params for k in p]
    gs = torch.autograd.grad((y ** 2).mean(), leaves)
    by = {}
    for (i, k), g in zip([(i, k) for i, p in enumerate(params) for k in p],
                         gs):
        by.setdefault(k, [None] * len(params))[i] = g.numpy()
    return y.detach().numpy(), {k: np.stack(v) for k, v in by.items()}


def _cases(pp):
    rng = np.random.default_rng(pp)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    cases = {"gpipe": (_per_stage(0, pp, 8, 16), x, 2 * pp, 1, False),
             "gpipe-grad": (_per_stage(1, pp, 4, 8), x[:8, :4], 2, 1, True)}
    for v in (2, 4):
        cases[f"interleave-{v}"] = (_per_stage(2 + v, pp * v, 8, 16), x,
                                    2, v, False)
    cases["interleave-grad"] = (_per_stage(7, pp * 2, 4, 8), x[:8, :4], 2,
                                2, True)
    return cases


@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_matches_sequential_and_the_reference(devices8, tmp_path,
                                                       pp):
    """GPipe (n_micro 2 pp) and interleaved (v 2 and 4, n_micro 2) equal
    the stages applied in order within 1e-4, as does the JAX
    ``pipeline_apply``; their gradients (summed over the stages' processes)
    equal the sequential ones; and the reference's ValueErrors."""
    cases = _cases(pp)
    inp = {"cases": {k: dict(params=_stacked(ps), x=x, n_micro=m,
                             interleave=v, grad=g)
                     for k, (ps, x, m, v, g) in cases.items()}}
    results = run_world("pipelines", pp, tmp_path, inp)
    mesh = jax_make_mesh(pp=pp, dp=8 // pp, devices=devices8)
    for key, (ps, x, n_micro, v, grad) in cases.items():
        want, want_grads = _sequential(ps, x, grad)
        for r in results:     # the output is replicated over pp
            assert np.abs(r[key]["y"] - want).max() < TOL, key
        if grad:
            for k, g in want_grads.items():
                assert np.abs(results[0][key]["d" + k] - g).max() < TOL, \
                    (key, k)
            continue
        ref = jax.jit(lambda p, x: jax_pipeline(
            lambda q, h: jax.numpy.tanh(h @ q["w1"] + q["b1"]) @ q["w2"]
            + q["b2"], p, x, mesh=mesh, n_micro=n_micro, interleave=v))(
                _stacked(ps), x)
        assert np.abs(results[0][key]["y"] - np.asarray(ref)).max() < TOL
    errors = results[0]["errors"]
    assert "n_micro <= pp" in errors["n_micro"]
    assert "leading axis" in errors["leading"]


def test_interleaved_pipeline_with_tensor_parallel_stages(tmp_path):
    """pp=2 x tp=2: each process passes its Megatron shards of the stages
    and the stage sums its partial product over tp (the reference's
    ``param_specs`` case, ``test_pipeline_interleaved_with_param_specs``)."""
    per = _per_stage(11, 4, 8, 16)
    x = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)
    results = run_world("pipeline_tp", 4, tmp_path,
                        {"params": _stacked(per), "x": x})
    want, _ = _sequential(per, x)
    for y in results:
        assert np.abs(y - want).max() < TOL


def test_stack_stage_params_stacks_each_leaf():
    per = [{"a": torch.full((2,), float(i)), "b": {"c": torch.ones(3) * i}}
           for i in range(3)]
    out = stack_stage_params(per)
    assert out["a"].shape == (3, 2) and out["b"]["c"].shape == (3, 3)
    assert torch.equal(out["b"]["c"][2], torch.full((3,), 2.0))
