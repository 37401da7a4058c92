"""The port's image task end to end on the CPU: the synthetic image stream
against the reference's, ``train.run --task image`` (ResNet with its batch
stats, ViT, gradient accumulation), a resume from its checkpoint against
an unbroken run, and the batch stats riding in a checkpoint."""
import numpy as np
import pytest
import torch

from kubeflow_tpu.data.loader import (
    synthetic_image_batches as jax_image_batches,
)
from kubeflow_tpu_torch.data.loader import (
    DeviceLoader,
    synthetic_image_batches,
)
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.train import run as trainer
from kubeflow_tpu_torch.train import steps
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

CLI = ["--task", "image", "--model", "resnet_tiny", "--batch", "4",
       "--image-size", "16", "--num-classes", "10", "--log-every", "1",
       "--lr", "0.1", "--device", "cpu"]


def test_image_stream_matches_reference():
    kw = dict(global_batch=3, image_size=8, num_classes=5, seed=7)
    got = list(synthetic_image_batches(start=2, steps=5, **kw))
    want = list(jax_image_batches(start=2, steps=5, **kw))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.float32 and gi.shape == (3, 8, 8, 3)
        assert gl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    moved = next(iter(DeviceLoader(got, "cpu")))
    assert isinstance(moved, tuple) and moved[0].shape == (3, 8, 8, 3)
    assert torch.equal(moved[1], torch.from_numpy(got[0][1]))


def _train_steps(out):
    return [line for line in out if line.startswith("train_step step=")]


@pytest.mark.parametrize("extra", [[], ["--grad-accum", "2"],
                                   ["--model", "vit_debug", "--image-size",
                                    "32"]],
                         ids=["resnet", "grad-accum", "vit"])
def test_train_run_image_task_on_cpu(capsys, extra):
    rc = trainer.main(CLI + ["--steps", "3"] + extra)
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[0] == ("devices=1 mesh={'pp': 1, 'dp': 1, 'fsdp': 1, "
                                  "'ep': 1, 'tp': 1, 'sp': 1} device=cpu")
    lines = _train_steps(out)
    assert len(lines) == 3
    assert all("loss=" in ln and "accuracy=" in ln for ln in lines)
    # An image batch has no tokens: no tokens/s or MFU, as in the
    # reference.
    assert "tokens_per_sec" not in out[-1]
    assert out[-1].startswith("done: step 3 loss=")


def _final(ckpt, step):
    mgr = CheckpointManager(ckpt)
    params = mgr.restore_params(step=step)
    optim = torch.load(f"{ckpt}/{step}/optimizer.pt", weights_only=True)
    return params, optim


def test_resumed_image_run_equals_an_unbroken_one(tmp_path, capsys):
    """4 steps in one run against 2, a stop, and 2 more from the
    checkpoint: weights, batch stats and momentum equal to the bit (the
    CPU's kernels are deterministic; the stream is step-indexed)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert trainer.main(CLI + ["--steps", "4", "--checkpoint-dir", a]) == 0
    unbroken = _train_steps(capsys.readouterr().out.splitlines())
    assert trainer.main(CLI + ["--steps", "2", "--checkpoint-dir", b]) == 0
    first = _train_steps(capsys.readouterr().out.splitlines())
    assert trainer.main(CLI + ["--steps", "4", "--checkpoint-dir", b]) == 0
    resumed = _train_steps(capsys.readouterr().out.splitlines())
    assert [ln.split()[1] for ln in resumed] == ["step=3", "step=4"]
    loss = lambda ln: ln.split()[2]
    assert [loss(x) for x in first + resumed] == [loss(x) for x in unbroken]
    pa, oa = _final(a, 4)
    pb, ob = _final(b, 4)
    stats = [k for k in pa if k.endswith((".mean", ".var"))]
    assert len(stats) == 12
    assert set(pa) == set(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for name, per in oa["state"].items():
        assert torch.equal(per["momentum_buffer"],
                           ob["state"][name]["momentum_buffer"]), name
    # The stats moved from their initial zeros and ones.
    assert not torch.equal(pa["norm_init.mean"], torch.zeros(8))


def test_checkpoint_restores_batch_stats_with_the_state(tmp_path):
    def state():
        model = create_model("resnet_tiny", device="cpu")
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        return steps.TrainState(model, steps.sgd(model.parameters(), 0.1,
                                                 momentum=0.9))

    s = state()
    step = steps.make_classification_train_step(has_batch_stats=True)
    rs = np.random.RandomState(0)
    batch = (torch.from_numpy(rs.randn(4, 16, 16, 3).astype(np.float32)),
             torch.from_numpy(rs.randint(0, 10, 4).astype(np.int32)))
    s, _ = step(s, batch)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, s)
        fresh = state()
        assert not all(torch.equal(t, fresh.batch_stats[k])
                       for k, t in s.batch_stats.items())
        mgr.restore(fresh)
    assert fresh.step == 1
    assert set(fresh.batch_stats) == set(s.batch_stats)
    for k, t in s.batch_stats.items():
        assert torch.equal(fresh.batch_stats[k], t), k
    # Training on continues identically from the restored state.
    s, m1 = step(s, batch)
    fresh, m2 = step(fresh, batch)
    assert m1["loss"].item() == m2["loss"].item()
    for k, t in s.batch_stats.items():
        assert torch.equal(fresh.batch_stats[k], t), k
