"""The PyTorch port's checkpoints (kubeflow_tpu_torch.train.checkpoint),
resume in its training loop, the trainer and server CLIs'
``--checkpoint-dir``, and the stacked ``layers_scan`` parameter layout,
against the JAX reference on the CPU at llama_debug size."""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.train import loop as jloop
from kubeflow_tpu.train import steps as jsteps
from kubeflow_tpu_torch.data.loader import synthetic_lm_batches
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models.convert import expected_leaves, params_from_jax
from kubeflow_tpu_torch.models.generate import generate, row_generators
from kubeflow_tpu_torch.models.serve import create_app, load_service
from kubeflow_tpu_torch.models.serve import main as serve_main
from kubeflow_tpu_torch.train import run as trainer
from kubeflow_tpu_torch.train import steps
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from kubeflow_tpu_torch.train.loop import LoopConfig, train_loop

REPO = Path(__file__).resolve().parents[1]
LR = 1e-2
BATCH, SEQ = 2, 32


@pytest.fixture(scope="module")
def jax_state():
    """The reference's llama_debug train state (f32 params, AdamW)."""
    model = JaxLlama(JAX_CONFIGS["llama_debug"])
    return jsteps.create_train_state(
        jax.random.key(0), model, jnp.ones((BATCH, SEQ), jnp.int32),
        optax.adamw(LR))


def _port_state(params):
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg,
                                          param_dtype=torch.float32))
    model.requires_grad_(True)
    return steps.TrainState(model, steps.adamw(model.parameters(), LR))


def _batches(start=0):
    """The trainer's step-indexed synthetic stream (numpy)."""
    return synthetic_lm_batches(global_batch=BATCH, seq_len=SEQ,
                                vocab_size=256, seed=0, start=start)


def _torch_batches(start=0):
    return (torch.from_numpy(b) for b in _batches(start))


def _copy_state(state):
    """Parameters, AdamW moments and step counts, copied."""
    opt = state.optimizer.state_dict()["state"]
    return ({n: p.detach().clone()
             for n, p in state.module.named_parameters()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()},
            state.step)


def _assert_equal_states(a, b):
    params_a, opt_a, step_a = a
    params_b, opt_b, step_b = b
    assert step_a == step_b
    assert set(params_a) == set(params_b)
    for name in params_a:
        assert torch.equal(params_a[name], params_b[name]), name
    assert set(opt_a) == set(opt_b)
    for i in opt_a:
        assert set(opt_a[i]) == {"step", "exp_avg", "exp_avg_sq"}
        for k in opt_a[i]:
            assert torch.equal(opt_a[i][k], opt_b[i][k]), (i, k)


def _tiny_state():
    module = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    return steps.TrainState(module, steps.adamw(module.parameters(), LR))


# -- CheckpointManager ---------------------------------------------------------


def test_round_trip_is_bit_equal_while_training_goes_on(jax_state, tmp_path):
    """Save after 2 steps, keep training in place while the write runs,
    restore into a fresh state: parameters, both AdamW moments, the
    optimizer's and the state's step counts equal the saved step's."""
    state = _port_state(jax_state.params)
    step = steps.make_lm_train_step()
    it = _torch_batches()
    for _ in range(2):
        state, _ = step(state, next(it))
    saved = _copy_state(state)
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.save(2, state) is True
    state, _ = step(state, next(it))        # updates the state in place
    mgr.wait()
    assert mgr.all_steps() == [2]
    fresh = _port_state(jax_state.params)
    assert mgr.restore(fresh) is fresh
    _assert_equal_states(_copy_state(fresh), saved)
    # The state keeps training from there as the original did.
    fresh, m = step(fresh, next(_torch_batches(2)))
    _assert_equal_states(_copy_state(fresh), _copy_state(state))
    mgr.close()


def test_max_to_keep_interval_and_force(tmp_path):
    state = _tiny_state()
    mgr = CheckpointManager(tmp_path, max_to_keep=2, save_interval_steps=3,
                            async_save=False)
    saved = [s for s in range(1, 8) if mgr.save(s, state)]
    assert saved == [3, 6]
    assert mgr.save(7, state, force=True) is True
    assert mgr.all_steps() == [6, 7] and mgr.latest_step() == 7
    assert mgr.save(9, state) is True           # a multiple of 3, past 7
    assert mgr.all_steps() == [7, 9]
    assert mgr.save(6, state) is False          # at or before the latest
    with pytest.raises(FileExistsError):
        mgr.save(9, state, force=True)
    meta = json.loads((tmp_path / "9" / "meta.json").read_text())
    assert meta == {"step": 9, "format": 1, "train_step": 0}
    assert sorted(os.listdir(tmp_path / "9")) == [
        "meta.json", "optimizer.pt", "params.pt"]
    with pytest.raises(ValueError):
        CheckpointManager(tmp_path, save_interval_steps=0)


def test_restore_returns_none_without_a_checkpoint(tmp_path):
    empty = tmp_path / "none"
    mgr = CheckpointManager(empty)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    assert mgr.restore(_tiny_state()) is None
    assert mgr.restore_params() is None
    assert not empty.exists()                   # restoring creates nothing


def test_restore_params_reads_no_optimizer_state(tmp_path):
    """Serving reads only the parameters: with the optimizer file gone,
    ``restore_params`` still loads them, into a template's dtype."""
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(1))
    state = steps.TrainState(model, steps.adamw(model.parameters(), LR), 5)
    with CheckpointManager(tmp_path) as mgr:
        mgr.save(5, state)
    os.remove(tmp_path / "5" / "optimizer.pt")
    mgr = CheckpointManager(tmp_path)
    raw = mgr.restore_params()
    want = model.state_dict()
    assert set(raw) == set(want)
    for name, t in raw.items():
        assert t.device.type == "cpu" and torch.equal(t, want[name])
    serving = create_model("llama_debug", device="cpu", dtype=torch.bfloat16)
    got = mgr.restore_params(step=5, template=serving)
    for name, t in got.items():
        ref = want[name].to(serving.state_dict()[name].dtype)
        assert t.dtype == ref.dtype and torch.equal(t, ref), name
    assert serving.layers[0].attn.q_proj.weight.dtype == torch.bfloat16
    assert serving.lm_head.weight.dtype == torch.float32
    with pytest.raises(KeyError, match="mismatch"):
        mgr.restore_params(template=torch.nn.Linear(2, 2))


def test_half_written_step_is_never_listed(tmp_path, monkeypatch):
    state = _tiny_state()
    mgr = CheckpointManager(tmp_path, async_save=True)
    assert mgr.save(1, state)
    mgr.wait()
    # Leftovers of a writer killed midway: a temporary directory with
    # files, and a step directory without its meta file.
    (tmp_path / ".tmp-2-dead").mkdir()
    (tmp_path / ".tmp-2-dead" / "params.pt").write_bytes(b"partial")
    (tmp_path / "3").mkdir()
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    # A write that fails leaves no step behind and raises from wait().
    real_save = torch.save

    def failing(obj, f, *a, **k):
        if isinstance(obj, dict) and "state" in obj:
            raise OSError("disk full")
        return real_save(obj, f, *a, **k)

    monkeypatch.setattr(torch, "save", failing)
    assert mgr.save(4, state)
    assert mgr.latest_step() == 4               # in flight
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == [1]
    assert not any(p.name.startswith(".tmp-4") for p in tmp_path.iterdir())
    assert mgr.restore(state).step == 0


# -- the loop: resume, stop, parity with the reference's loop ------------------


def _losses(history):
    return [h["loss"] for h in history]


def _run_port(params, total, ckpt=None, every=100, stop=None, on_log=None):
    state = _port_state(params)
    cfg = LoopConfig(total_steps=total, log_every=1, checkpoint_dir=ckpt,
                     checkpoint_every=every)
    return train_loop(state, steps.make_lm_train_step(), _torch_batches, cfg,
                      stop=stop, on_log=on_log or (lambda s, v: None))


def test_resumed_loop_is_bit_equal_and_matches_the_jax_loop(jax_state,
                                                            tmp_path):
    """4 unbroken steps against 2 steps, a new process's state and a
    resume for 2 more: the port's resumed run repeats its unbroken run to
    the bit; its losses match the reference's loop, run the same way
    (checkpoint, resume) over the same parameters, within 1e-5."""
    unbroken, hist_u = _run_port(jax_state.params, 4)
    _, hist_a = _run_port(jax_state.params, 2, tmp_path / "port", every=2)
    resumed, hist_b = _run_port(jax_state.params, 4, tmp_path / "port")
    assert [h["step"] for h in hist_b] == [3, 4] and resumed.step == 4
    assert _losses(hist_a + hist_b) == _losses(hist_u)
    for (name, a), b in zip(resumed.module.state_dict().items(),
                            unbroken.module.state_dict().values()):
        assert torch.equal(a, b), name
    assert CheckpointManager(tmp_path / "port").all_steps() == [2, 4]

    jstep = jax.jit(jsteps.make_lm_train_step())
    jbatches = lambda start: (jnp.asarray(b) for b in _batches(start))
    jax_hist = []
    log = lambda s, v: jax_hist.append(v["loss"])
    for total in (2, 4):
        jloop.train_loop(
            jax_state, jstep, jbatches,
            jloop.LoopConfig(total_steps=total, log_every=1,
                             checkpoint_dir=str(tmp_path / "jax"),
                             checkpoint_every=2),
            on_log=log)
    assert len(jax_hist) == 4
    np.testing.assert_allclose(_losses(hist_u), jax_hist, rtol=1e-5)


def test_stop_saves_at_the_state_step(jax_state, tmp_path):
    stop = threading.Event()

    def on_log(step, vals):
        if step == 2:
            stop.set()

    state, hist = _run_port(jax_state.params, 10, tmp_path, every=100,
                            stop=stop, on_log=on_log)
    assert state.step == 2
    mgr = CheckpointManager(tmp_path)
    assert mgr.all_steps() == [2]
    assert mgr.restore(_port_state(jax_state.params)).step == 2


# -- the CLIs: train, preempt, resume, then serve what training wrote ----------


def test_train_run_checkpoint_dir_then_serve_it(tmp_path, monkeypatch,
                                               capsys):
    """``train.run --checkpoint-dir`` (here from $KFT_CHECKPOINT_DIR) is
    stopped by SIGTERM, saves, resumes to its step count; ``serve
    --checkpoint-dir`` then serves the trained parameters over HTTP."""
    ckpt = tmp_path / "run"
    args = ["--model", "llama_debug", "--batch", "2", "--seq", "32",
            "--log-every", "1", "--device", "cpu", "--checkpoint-every", "2"]
    env = dict(os.environ, KFT_CHECKPOINT_DIR=str(ckpt), PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.train.run", "--steps",
         "100000"] + args, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(180, proc.kill)   # never hang the suite
    watchdog.start()
    try:
        for line in proc.stdout:
            if line.startswith("train_step step=3 "):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        proc.kill()
    assert proc.returncode == 0, err
    preempted = [ln for ln in out.splitlines() if ln.startswith("preempted")]
    assert len(preempted) == 1 and preempted[0].endswith(
        ": checkpoint saved"), out
    at = int(preempted[0].split()[3].rstrip(":"))
    assert at >= 3 and CheckpointManager(ckpt).latest_step() == at

    monkeypatch.setenv("KFT_CHECKPOINT_DIR", str(ckpt))
    assert trainer.main(["--steps", str(at + 2)] + args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith(f"done: step {at + 2} ")
    assert any(ln.startswith(f"checkpoint step={at + 2} ") for ln in out)

    # The same run, unbroken, from the same seed: its final parameters
    # are what the server must hold (llama_debug serves in f32).
    monkeypatch.delenv("KFT_CHECKPOINT_DIR")
    _, ns = trainer.parse_args(["--steps", str(at + 2)] + args)
    state, _ = trainer.train(ns, torch.device("cpu"))
    service = load_service("llama_debug", device="cpu", checkpoint_dir=ckpt)
    served = service.model.state_dict()
    for name, t in state.module.state_dict().items():
        assert torch.equal(served[name], t), name

    app = create_app(service, model_name="llama_debug")
    body = json.dumps({"tokens": [[5, 9, 2], [7]], "max_new_tokens": 5})
    status, _, raw = app.handle("POST", "/v1/generate", {}, body.encode())
    assert status == 200 and service._scheduler is not None
    prompt = torch.tensor([[5, 9, 2], [7, 0, 0]])
    mask = prompt != 0
    mask[1, 0] = True
    want = generate(service.model, prompt, prompt_mask=mask,
                    max_new_tokens=5,
                    generators=row_generators(0, 2, "cpu")).tolist()
    assert json.loads(raw)["tokens"] == want

    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_service("llama_debug", device="cpu",
                     checkpoint_dir=tmp_path / "empty")
    with pytest.raises(SystemExit):
        serve_main(["--model", "llama_debug", "--device", "cpu",
                    "--checkpoint-dir", str(tmp_path / "empty")])
    assert "no checkpoint found" in capsys.readouterr().err


# -- the stacked layers_scan layout --------------------------------------------


def test_layers_scan_conversion_equals_layer_i_conversion():
    """A ``scan_layers=True`` tree converts to the state dict its
    unstacked ``layer_i`` tree converts to, and the port's model with it
    gives the reference's logits."""
    jm = JaxLlama(dataclasses.replace(JAX_CONFIGS["llama_debug"],
                                      scan_layers=True))
    tokens = jnp.asarray(np.random.RandomState(2).randint(0, 256, (2, 12)),
                         jnp.int32)
    params = jax.device_get(jm.init(jax.random.key(4), tokens)["params"])
    port = create_model("llama_debug", device="cpu")
    flat_shapes = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat_shapes[path] = tuple(v.shape)

    walk(params)
    assert flat_shapes == expected_leaves(port.cfg, scan_layers=True)
    stacked = params["layers_scan"]["block"]
    unrolled = {k: v for k, v in params.items() if k != "layers_scan"}
    for i in range(port.cfg.n_layers):
        unrolled[f"layer_{i}"] = jax.tree_util.tree_map(lambda a: a[i],
                                                        stacked)
    from_scan = params_from_jax(params, port.cfg)
    from_layers = params_from_jax(unrolled, port.cfg)
    assert set(from_scan) == set(from_layers)
    for name in from_scan:
        assert torch.equal(from_scan[name], from_layers[name]), name
    port.load_state_dict(from_scan)
    want = jm.apply({"params": params}, tokens)
    with torch.no_grad():
        got = port(torch.tensor(np.asarray(tokens)).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    bad = {**params, "layers_scan": {"block": {
        **stacked, "mlp_norm": {"scale": stacked["mlp_norm"]["scale"][:1]}}}}
    with pytest.raises(ValueError, match="mlp_norm"):
        params_from_jax(bad, port.cfg)
