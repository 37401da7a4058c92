"""The PyTorch port's weight-only int8 (kubeflow_tpu_torch.models.quantize)
against the JAX reference's (kubeflow_tpu.models.quantize) on the CPU.

The same f32 parameters go through ``quantize_params`` and the port's
``quantize_model``: the int8 values and the scales must be bit-equal on
every selected leaf, the leaves the reference leaves alone (MoE expert
tensors, norm scales) untouched, and the dequantized weights bit-equal to
``dequantize_params``.  Quantized ``llama_debug`` logits within 1e-4 of
the reference's, greedy tokens equal; the service serves int8 on every
engine.
"""
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu.models.quantize import (
    QTensor,
    dequantize_params,
    quantize_params,
)
from kubeflow_tpu.models.quantize import quantized_bytes as jax_bytes
from kubeflow_tpu_torch.models import create_model, serve
from kubeflow_tpu_torch.models import generate as tgen
from kubeflow_tpu_torch.models.convert import (
    _convert,
    _flatten,
    _target,
    params_from_jax,
)
from kubeflow_tpu_torch.models.quantize import (
    dequantize,
    quantize_model,
    quantize_tensor,
    quantized_bytes,
)
from kubeflow_tpu_torch.models.serve import create_app, load_service
from kubeflow_tpu_torch.train import steps
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager


def _reference(name, seed=0):
    jm = JaxLlama(JAX_CONFIGS[name])
    params = jm.init(jax.random.key(seed), jnp.ones((1, 8), jnp.int32))[
        "params"]
    return jm, params


def _port(name, params):
    model = create_model(name, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg))
    return model


def _qtensors(qparams):
    """Reference leaf path -> QTensor."""
    out = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, QTensor):
                out[path] = val
            elif isinstance(val, dict):
                walk(val, path)

    walk(qparams, "")
    return out


def _port_layout(path, arr):
    """A reference kernel-layout array in the port's [out, in] layout."""
    return _convert(path, np.asarray(arr))


@pytest.fixture(scope="module", params=["llama_debug", "mixtral_debug"])
def quantized(request):
    name = request.param
    jm, params = _reference(name)
    qparams = quantize_params(params)
    model = _port(name, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    quantize_model(model)
    return name, jm, params, qparams, model, before


def test_int8_values_and_scales_equal_quantize_params(quantized):
    """Each leaf kind on the reference's axes: q/k/v one scale a head_dim
    index, the embedding one a column, o_proj, the SwiGLU, lm_head and the
    router one an output row."""
    name, _, _, qparams, model, before = quantized
    state = model.state_dict()
    qt = _qtensors(qparams)
    kinds = set()
    for path, t in qt.items():
        key = _target(path)
        module = key.rsplit(".", 1)[0]
        q = state[f"{module}.qweight"]
        assert q.dtype == torch.int8
        if path == "embed/embedding":
            want_q = np.asarray(t.q)
        else:
            want_q = _port_layout(path, t.q)
        np.testing.assert_array_equal(q.numpy(), want_q, err_msg=path)
        scale = state[f"{module}.scale"]
        assert scale.dtype == torch.float32
        assert scale.numel() == t.scale.size, path
        np.testing.assert_array_equal(scale.numpy().reshape(-1),
                                      np.asarray(t.scale).reshape(-1),
                                      err_msg=path)
        kinds.add(path.split("/")[-2])
    want_kinds = {"q_proj", "k_proj", "v_proj", "o_proj", "embed",
                  "lm_head"}
    want_kinds |= ({"router"} if name == "mixtral_debug"
                   else {"gate_proj", "up_proj", "down_proj"})
    assert kinds == want_kinds
    # What the reference leaves alone stays as it was, bit for bit.
    kept = [k for k in state if not k.endswith(("qweight", "scale"))
            or k.endswith("norm.scale")]
    assert kept and all(torch.equal(state[k], before[k]) for k in kept)
    if name == "mixtral_debug":
        assert {k.rsplit(".", 1)[1] for k in kept} >= {"w_gate", "w_up",
                                                       "w_down"}


def test_dequantized_weights_equal_dequantize_params(quantized):
    _, _, _, qparams, model, _ = quantized
    deq = _flatten(jax.device_get(dequantize_params(qparams)))
    for path, t in _qtensors(qparams).items():
        mod = model.get_submodule(_target(path).rsplit(".", 1)[0])
        if path == "embed/embedding":
            rows = torch.arange(mod.qweight.shape[0])
            got = mod(rows).float().numpy()
            want = np.asarray(deq[path]).astype(np.float32)
        else:
            got = mod.dense_weight().float().numpy()
            want = _port_layout(path, deq[path].astype(np.float32))
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_quantized_bytes_equal_the_reference(quantized):
    _, _, params, qparams, model, _ = quantized
    assert quantized_bytes(model) == jax_bytes(qparams)
    full = _port(quantized[0], params)
    assert quantized_bytes(full) == jax_bytes(params)


def test_quantized_logits_and_greedy_tokens_match_the_reference(quantized):
    _, jm, _, qparams, model, _ = quantized
    rs = np.random.RandomState(4)
    tokens = rs.randint(0, 256, size=(2, 20))
    want = jm.apply({"params": dequantize_params(qparams)},
                    jnp.asarray(tokens))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    lens = (4, 11)
    mask = np.arange(11)[None] < np.array(lens)[:, None]
    prompt = np.where(mask, tokens[:, :11], 0).astype(np.int32)
    want_tok = jgen.generate(jm, qparams, jnp.asarray(prompt),
                             prompt_mask=jnp.asarray(mask), max_new_tokens=8)
    got_tok = tgen.generate(model, torch.from_numpy(prompt).long(),
                            prompt_mask=torch.from_numpy(mask),
                            max_new_tokens=8)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


def test_quantize_tensor_rounds_half_to_even_and_clips():
    w = torch.tensor([[127.0, 0.5, 1.5, -2.5, -127.0, 3.49]])
    q, scale = quantize_tensor(w, (1,))
    assert scale.shape == (1, 1) and scale.item() == 1.0
    assert q.tolist() == [[127, 0, 2, -2, -127, 3]]
    zero, s0 = quantize_tensor(torch.zeros(2, 3), (1,))
    assert torch.equal(zero, torch.zeros(2, 3, dtype=torch.int8))
    assert s0.flatten().tolist() == [np.float32(1e-12)] * 2
    assert dequantize(q, scale, torch.float32).tolist() == [
        [127.0, 0.0, 2.0, -2.0, -127.0, 3.0]]


def test_predicate_overrides_the_pattern():
    model = create_model("llama_debug", device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    seen = []

    def only_lm_head(path, w):
        seen.append(path)
        return path == "lm_head.kernel"

    quantize_model(model, predicate=only_lm_head)
    assert "layer_0.attn.q_proj.kernel" in seen
    assert "embed.embedding" in seen
    assert model.lm_head.weight is None and model.lm_head.qweight.dtype \
        == torch.int8
    assert model.layers[0].attn.q_proj.weight is not None


def _post(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


ENGINES = {"lock": ({"KFT_SERVE_SCHEDULER": "0"}, None),
           "fixed": ({"KFT_SERVE_PAGED": "0"}, None),
           "paged": ({}, None),
           "spec": ({}, "llama_debug")}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_load_service_int8_serves_on_every_engine(engine, monkeypatch):
    """Over HTTP, each engine's tokens equal ``generate()`` on the same
    int8 model; the draft stays unquantized; /debug/serve reports it."""
    import threading

    env, draft = ENGINES[engine]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("KFT_SERVE_SLOT_LEN", "64")
    monkeypatch.setenv("KFT_SERVE_PAGE_LEN", "16")
    service = load_service("llama_debug", device="cpu", seed=3,
                           quantize="int8", max_seq_len=64,
                           draft_model_name=draft)
    model = service.model
    assert model.layers[0].attn.q_proj.weight is None
    assert model.embed.qweight.dtype == torch.int8
    if draft:
        assert service.draft_model.layers[0].attn.q_proj.weight is not None
    rows = [[5, 6, 7, 8, 9], [1, 2, 3]]
    prompt = torch.tensor([rows[0], rows[1] + [0, 0]])
    mask = torch.tensor([[True] * 5, [True] * 3 + [False] * 2])
    want = tgen.generate(model, prompt, prompt_mask=mask,
                         max_new_tokens=6).tolist()
    server = create_app(service, model_name="llama_debug").make_server(
        "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, out = _post(base, "/v1/generate",
                            {"tokens": rows, "max_new_tokens": 6})
        _, debug = _post(base, "/debug/serve")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if service._scheduler is not None:
            service._scheduler.stop()
    assert not thread.is_alive()
    assert status == 200 and out["tokens"] == want
    assert debug["quantize"] == "int8"
    assert debug["weight_bytes"] == quantized_bytes(model)
    engine_name = {"lock": None, "fixed": "DecodeScheduler"}.get(
        engine, "PagedDecodeScheduler")
    assert debug["engine"] == engine_name


def test_unsupported_quantization_and_mesh_raise():
    with pytest.raises(ValueError, match=r"unsupported quantization 'int4' "
                                         r"\(int8\)"):
        load_service("llama_debug", device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="quantize"):
        load_service("llama_debug", device="cpu", quantize="int8",
                     mesh_spec="tp=2")


def test_checkpoint_restored_as_int8_gives_the_reference_q_and_scales(
        tmp_path):
    """A trainer's f32 checkpoint served with ``quantize="int8"`` is
    quantized from the saved f32 values, not from the bf16 serving copy:
    q and scales equal ``quantize_params`` of the same f32 tree."""
    _, params = _reference("llama_debug", seed=5)
    model = create_model("llama_debug", device="cpu",
                         param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg,
                                          param_dtype=torch.float32))
    state = steps.TrainState(model, steps.adamw(model.parameters(), 1e-3), 7)
    with CheckpointManager(tmp_path) as mgr:
        mgr.save(7, state)
    # The serving copy in bf16 (llama_debug computes in f32, so the bf16
    # model is built directly): quantizing it would round first.
    served = serve._load_model(
        create_model("llama_debug", device="cpu", dtype=torch.bfloat16),
        str(tmp_path), 0, quantize=True)
    rounded = serve._load_model(
        create_model("llama_debug", device="cpu", dtype=torch.bfloat16),
        str(tmp_path), 0)
    quantize_model(rounded)
    differs = False
    for path, t in _qtensors(quantize_params(params)).items():
        key = _target(path).rsplit(".", 1)[0]
        mod = served.get_submodule(key)
        want_q = (np.asarray(t.q) if path == "embed/embedding"
                  else _port_layout(path, t.q))
        np.testing.assert_array_equal(mod.qweight.numpy(), want_q,
                                      err_msg=path)
        np.testing.assert_array_equal(mod.scale.numpy().reshape(-1),
                                      np.asarray(t.scale).reshape(-1),
                                      err_msg=path)
        other = rounded.get_submodule(key)
        differs |= not (torch.equal(other.qweight, mod.qweight)
                        and torch.equal(other.scale, mod.scale))
    assert differs
    assert torch.equal(served.final_norm.scale,
                       model.final_norm.scale.detach())
    service = load_service("llama_debug", device="cpu", quantize="int8",
                           checkpoint_dir=str(tmp_path))
    assert service.quantize == "int8"
    assert torch.equal(service.model.embed.qweight, served.embed.qweight)
    out = service.generate([[1, 2, 3]], max_new_tokens=3)
    assert len(out[0]) == 3
