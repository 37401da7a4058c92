"""The PyTorch port's decoder-only beam search
(kubeflow_tpu_torch.models.generate.beam_search) against the JAX
reference's on ``llama_debug``, with the reference's initial parameters
carried across by ``models/convert.params_from_jax``: tokens exactly
equal on a right-padded batch for beams 1, 3 and 4, with and without
EOS freezing and length normalisation; padding a prompt does not change
its beams; beams 1 is greedy ``generate``; the rescored best of 4 beams
is no worse than 1 beam's (tests/test_generate.py's checks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import generate as jgen
from kubeflow_tpu.models.llama import CONFIGS as JAX_CONFIGS
from kubeflow_tpu.models.llama import Llama as JaxLlama
from kubeflow_tpu_torch.models import create_model
from kubeflow_tpu_torch.models import generate as tgen
from kubeflow_tpu_torch.models.convert import params_from_jax

LENS = (9, 4, 7)
NEW = 8


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlama(JAX_CONFIGS["llama_debug"])
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    model = create_model("llama_debug", device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params), model.cfg))
    rs = np.random.RandomState(1)
    mask = np.arange(max(LENS))[None] < np.array(LENS)[:, None]
    prompt = np.where(mask, rs.randint(0, 256, mask.shape), 0).astype(
        np.int32)
    return jm, params, model, prompt, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _greedy(pair):
    _, _, model, prompt, mask = pair
    return tgen.generate(model, _t(prompt).long(), prompt_mask=_t(mask),
                         max_new_tokens=NEW)


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
@pytest.mark.parametrize("eos", [None, "planted"])
@pytest.mark.parametrize("beams", [1, 3, 4])
def test_beam_search_equals_reference(pair, beams, eos, length_penalty):
    jm, params, model, prompt, mask = pair
    # A token greedy emits mid-run, so EOS freezes beams.
    eos_token = None if eos is None else int(_greedy(pair)[1, 2])
    kw = dict(max_new_tokens=NEW, beams=beams, eos_token=eos_token,
              length_penalty=length_penalty)
    want = jgen.beam_search(jm, params, jnp.asarray(prompt),
                            prompt_mask=jnp.asarray(mask), **kw)
    got = tgen.beam_search(model, _t(prompt).long(), prompt_mask=_t(mask),
                           **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam_search_respects_prompt_padding(pair):
    jm, params, model, _, _ = pair
    short = np.array([[3, 7, 11]], np.int32)
    padded = np.array([[3, 7, 11, 0, 0]], np.int32)
    pmask = np.array([[1, 1, 1, 0, 0]], bool)
    a = tgen.beam_search(model, _t(short).long(), max_new_tokens=6, beams=3)
    b = tgen.beam_search(model, _t(padded).long(), prompt_mask=_t(pmask),
                         max_new_tokens=6, beams=3)
    assert torch.equal(a, b)
    want = jgen.beam_search(jm, params, jnp.asarray(short),
                            max_new_tokens=6, beams=3)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))


def test_beam1_equals_generate(pair):
    _, _, model, prompt, mask = pair
    beam1 = tgen.beam_search(model, _t(prompt).long(), prompt_mask=_t(mask),
                             max_new_tokens=NEW, beams=1)
    assert torch.equal(beam1, _greedy(pair))


def test_wider_beam_scores_no_worse(pair):
    """Rescored by one teacher-forced forward, the best of 4 beams is no
    worse than 1 beam's sequence (length_penalty 0: by score alone)."""
    _, _, model, prompt, mask = pair
    kw = dict(prompt_mask=_t(mask), max_new_tokens=NEW, length_penalty=0.0)
    scores = []
    for beams in (1, 4):
        seqs = tgen.beam_search(model, _t(prompt).long(), beams=beams, **kw)
        total = []
        for row, n, seq in zip(prompt, LENS, seqs.tolist()):
            full = torch.tensor([row[:n].tolist() + seq])
            with torch.no_grad():
                logp = torch.log_softmax(model(full)[0].float(), dim=-1)
            total.append(sum(logp[n - 1 + t, tok].item()
                             for t, tok in enumerate(seq)))
        scores.append(np.array(total))
    assert (scores[1] >= scores[0] - 1e-4).all(), scores
