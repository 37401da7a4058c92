"""The PyTorch port's data pipeline, FLOPs accounting and train loop against
the JAX reference on the CPU: the synthetic streams and the packer must
give the reference's numbers exactly for the same seed."""
import itertools

import numpy as np
import pytest
import torch

from kubeflow_tpu.data import loader as jloader
from kubeflow_tpu.data import packing as jpacking
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.telemetry import compute as jcompute
from kubeflow_tpu_torch.data import loader, packing
from kubeflow_tpu_torch.models.llama import CONFIGS
from kubeflow_tpu_torch.telemetry import compute
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from kubeflow_tpu_torch.train.loop import LoopConfig, train_loop
from kubeflow_tpu_torch.train.steps import TrainState


@pytest.mark.parametrize("seed,start", [(0, 0), (7, 3)])
def test_synthetic_lm_batches_equal_the_reference_stream(seed, start):
    kw = dict(global_batch=4, seq_len=64, vocab_size=1000, seed=seed,
              start=start, steps=start + 3)
    got = list(loader.synthetic_lm_batches(**kw))
    want = list(jloader.synthetic_lm_batches(**kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_synthetic_lm_documents_equal_the_reference_stream():
    kw = dict(vocab_size=500, seed=3, min_len=4, max_len=40, docs=20)
    got = list(loader.synthetic_lm_documents(**kw))
    want = list(jloader.synthetic_lm_documents(**kw))
    assert len(got) == 20
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 1


def test_pack_documents_and_tokens_equal_the_reference():
    rs = np.random.RandomState(1)
    lengths = rs.randint(1, 65, size=200)
    got = packing.pack_documents(lengths, 64)
    for want in (jpacking.pack_documents(lengths, 64),
                 jpacking._pack_python(lengths, 64)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    docs = [rs.randint(1, 100, size=n).astype(np.int32) for n in lengths[:30]]
    for a, b in zip(packing.pack_tokens(docs, 64),
                    jpacking.pack_tokens(docs, 64)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="row_len"):
        packing.pack_documents([3, 65], 64)


def test_packed_lm_batches_equal_the_reference_stream():
    def stream(mod, docs_mod):
        docs = docs_mod.synthetic_lm_documents(vocab_size=300, seed=2,
                                               min_len=8, max_len=128)
        return list(itertools.islice(
            mod.packed_lm_batches(docs, batch_rows=3, seq_len=128), 4))

    got, want = stream(packing, loader), stream(jpacking, jloader)
    for (t, s), (wt, ws) in zip(got, want):
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(s, ws)
        assert (t[s == 0] == 0).all()
    assert len(got) == 4 and max(s.max() for _, s in got) >= 2


def test_device_loader_moves_arrays_and_pairs():
    batches = [np.arange(6, dtype=np.int32).reshape(2, 3),
               (np.ones((2, 3), np.int32), np.zeros((2, 3), np.int32))]
    out = list(loader.DeviceLoader(batches, "cpu"))
    assert isinstance(out[0], torch.Tensor) and out[0].dtype == torch.int32
    assert out[0].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert isinstance(out[1], tuple) and len(out[1]) == 2
    assert out[1][1].sum().item() == 0


@pytest.mark.parametrize("name", ["llama_debug", "llama_1b4", "llama3_8b"])
def test_flops_per_token_is_the_reference_formula(name):
    for seq in (256, 8192):
        assert compute.lm_train_flops_per_token(CONFIGS[name], seq) == \
            jcompute.lm_train_flops_per_token(JAX_CONFIGS[name], seq)


def test_mfu_is_against_the_h100_peak():
    assert compute.H100_SXM_BF16_PEAK_TFS == 989.0
    # llama_1b4 at b1 s8192: ~10.2 GFLOP a token.
    fpt = compute.lm_train_flops_per_token(CONFIGS["llama_1b4"], 8192)
    assert 10.0e9 < fpt < 10.4e9
    vals = compute.update_throughput(8192.0, flops_per_token=fpt)
    assert vals["mfu"] == pytest.approx(8192 * fpt / 989e12)
    assert compute.mfu(8192.0, fpt) == pytest.approx(vals["mfu"])
    assert "train_mfu" in compute.registry.render()


def test_train_loop_logs_windows_and_refuses_checkpoints(tmp_path):
    seen = []

    def step(state, batch):
        return state + 1, {"loss": torch.tensor(float(batch.sum()))}

    batches = [torch.ones(2, 4, dtype=torch.int32) * i for i in range(5)]
    cfg = LoopConfig(total_steps=4, log_every=2, tokens_per_step=8,
                     flops_per_token=1e6)
    state, history = train_loop(0, step, batches, cfg,
                                on_log=lambda n, v: seen.append(n))
    assert state == 4 and seen == [2, 4]
    assert [h["step"] for h in history] == [2, 4]
    assert history[1]["loss"] == 3 * 8.0
    assert history[0]["step_seconds"] > 0
    assert {"tokens_per_sec", "mfu", "steps_per_sec"} <= set(history[0])
    # Checkpoints are ported (tests/test_torch_checkpoint.py): with a
    # directory the loop saves the state's step, and a rerun resumes
    # there and counts its steps from it.
    def train_state():
        return TrainState(torch.nn.Linear(2, 2), None)

    def count(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(float(batch.sum()))}

    ckpt = str(tmp_path / "ckpt")
    first, _ = train_loop(train_state(), count, batches,
                          LoopConfig(total_steps=2, checkpoint_dir=ckpt))
    assert first.step == 2 and CheckpointManager(ckpt).all_steps() == [2]
    resumed, hist = train_loop(
        train_state(), count, lambda start: batches[start:],
        LoopConfig(total_steps=3, log_every=1, checkpoint_dir=ckpt))
    assert resumed.step == 3 and [h["step"] for h in hist] == [3]
    assert hist[0]["loss"] == 2 * 8.0
    # A stopped loop runs no step; an exhausted stream ends the loop.
    stop = type("Stop", (), {"is_set": lambda self: True})()
    assert train_loop(0, step, batches, cfg, stop=stop) == (0, [])
    assert train_loop(0, step, batches[:1], cfg)[0] == 1
