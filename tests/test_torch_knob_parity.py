"""One knob registry: the port's model side reads its environment knobs
through ``platform/config.py`` as the reference's reads through its
own, so the same names show in ``config.effective()`` (``/debug/knobs``,
an incident bundle's ``knobs``) with the same defaults, and a strict
knob refuses a bad value in both.  Each package runs in a fresh
interpreter with every ``KFT_*``, ``SERVE_*`` and ``TRAIN_*`` variable
unset: a fixed-slot scheduler, a paged engine, a serve tracer and a
train loop at debug size register what they read."""
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIXES = ("KFT_", "SERVE_", "TRAIN_")
# (knob, a value its check refuses)
STRICT_BAD = [("KFT_SERVE_PAGE_LEN", "0"), ("KFT_SERVE_PAGE_LEN", "banana"),
              ("KFT_SERVE_PAGES", "-2"), ("KFT_SERVE_PREFILL_CHUNK", "-1"),
              ("KFT_SERVE_SPEC_TOKENS", "65")]

_TAIL = f"""
    import os
    knobs = {{n: v["default"] for n, v in config.effective().items()
             if n.startswith({PREFIXES!r})}}
    refused = []
    for name, bad in {STRICT_BAD!r}:
        os.environ[name] = bad
        try:
            make_paged()
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
        del os.environ[name]
    print(json.dumps({{"knobs": knobs, "refused": refused}}))
"""
PORT = """
    import json
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.paged import PagedDecodeScheduler
    from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
    from kubeflow_tpu_torch.platform import config
    from kubeflow_tpu_torch.telemetry.metrics import Registry
    from kubeflow_tpu_torch.telemetry.serve import ServeTelemetry
    from kubeflow_tpu_torch.train import loop

    model = create_model("llama_debug", device="cpu", max_seq_len=64)
    def make_paged():
        PagedDecodeScheduler(model).stop()
    DecodeScheduler(model).stop()
    make_paged()
    ServeTelemetry(Registry())
    loop.train_loop(0, lambda s, b: (s + 1, {}), [],
                    loop.LoopConfig(total_steps=0))
""" + _TAIL
REFERENCE = """
    import dataclasses, json
    import jax, jax.numpy as jnp
    from prometheus_client import CollectorRegistry
    from kubeflow_tpu.models.llama import CONFIGS, Llama
    from kubeflow_tpu.models.paged import PagedDecodeScheduler
    from kubeflow_tpu.models.scheduler import DecodeScheduler
    from kubeflow_tpu.platform import config
    from kubeflow_tpu.telemetry.serve import ServeTelemetry
    from kubeflow_tpu.train import loop

    model = Llama(dataclasses.replace(CONFIGS["llama_debug"], max_seq_len=64))
    params = model.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))[
        "params"]
    def make_paged():
        PagedDecodeScheduler(model, params).stop()
    DecodeScheduler(model, params).stop()
    make_paged()
    ServeTelemetry(CollectorRegistry())
    loop.train_loop(0, lambda s, b: (s + 1, {}), [],
                    loop.LoopConfig(total_steps=0))
""" + _TAIL


def _start(code):
    env = {k: v for k, v in os.environ.items() if not k.startswith(PREFIXES)}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_model_side_knobs_and_strict_refusals_equal_the_references():
    procs = {"port": _start(PORT), "reference": _start(REFERENCE)}
    seen = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{name}: {err[-4000:]}"
        seen[name] = json.loads(out.strip().splitlines()[-1])
    port, ref = seen["port"], seen["reference"]
    assert port["knobs"] == ref["knobs"]
    for name in ("KFT_SERVE_SLOTS", "KFT_SERVE_PAGE_LEN", "KFT_SERVE_PIPELINE",
                 "SERVE_TRACE_BUFFER_SIZE", "TRAIN_SLOW_STEP_SECONDS",
                 "KFT_SLOW_STEP_PROFILE_DIR"):
        assert name in port["knobs"], name
    assert all(port["refused"]), port["refused"]
    assert port["refused"] == ref["refused"]
