"""Autoregressive generation with a KV cache — counterpart of
``kubeflow_tpu/models/generate.py`` (decoder-only paths).

* **Prefill** runs the whole right-padded prompt in one pass, writing the
  cache at index 0 (causal flash attention over the fresh tokens).
* **Decode** is a Python loop of single-token steps; every step writes
  its K/V at the shared scalar cache index and attends over the whole
  cache with one bias row per batch row (``Llama.forward``).  The same
  step body (``decode_step``) drives the continuous-batching slot pool
  (``models/scheduler.py``), with a per-row write slot instead.
* Sampling is per row: row i draws its Gumbel noise from its own
  ``torch.Generator``, so a row's stream depends on its generator only.
  A caller (a parity test) may inject the noise instead.

Everything runs eagerly under ``torch.inference_mode``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from kubeflow_tpu_torch.models.layers import KVCache

NEG_INF = -1e30


def row_generators(seed: int, batch: int, device) -> List[torch.Generator]:
    """One generator per batch row, seeded from (seed, row)."""
    dev = torch.device(device)
    return [torch.Generator(device=dev).manual_seed(seed * 65536 + i)
            for i in range(batch)]


def gumbel_noise(generators: Sequence[torch.Generator], vocab: int,
                 device) -> torch.Tensor:
    """[b, vocab] standard Gumbel noise, row i from ``generators[i]``
    (the reference's formula: -log(-log(U)), U clipped away from 0)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.stack([torch.rand(vocab, generator=g, device=device)
                     for g in generators])
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample_logits_rows(logits: torch.Tensor, *, temps: torch.Tensor,
                       top_ks: torch.Tensor, sampled: bool = True,
                       generators: Optional[Sequence[torch.Generator]] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row sampling over [b, vocab] logits: row i uses ``temps[i]``
    (0 is greedy) and ``top_ks[i]`` (<= 0 is unrestricted).  The draw is
    argmax(masked logits + Gumbel noise) — the reference's
    ``jax.random.categorical`` — with the noise from ``generators`` or
    injected as ``noise`` [b, vocab].  ``sampled=False`` is pure argmax."""
    greedy = logits.argmax(dim=-1)
    if not sampled:
        return greedy
    vocab = logits.shape[-1]
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    ks = torch.where(top_ks > 0, top_ks, vocab).clamp(1, vocab)
    # kth-largest per row with a per-row k: descending sort + gather.
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (ks - 1)[:, None])
    masked = torch.where(scaled < kth, NEG_INF, scaled)
    if noise is None:
        if generators is None:
            raise ValueError("sampling needs generators or noise")
        noise = gumbel_noise(generators, vocab, logits.device)
    pick = (masked + noise).argmax(dim=-1)
    return torch.where(temps == 0.0, greedy, pick)


@dataclasses.dataclass
class SamplingRows:
    """Scalar request knobs as per-row tensors."""

    temps: torch.Tensor
    top_ks: torch.Tensor
    eos_ids: torch.Tensor
    has_eos: torch.Tensor
    sampled: bool

    @classmethod
    def make(cls, b: int, device, temperature: float, top_k, eos_token):
        return cls(
            temps=torch.full((b,), float(temperature), device=device),
            top_ks=torch.full((b,), int(top_k or 0), device=device),
            eos_ids=torch.full((b,), eos_token if eos_token is not None
                               else 0, device=device),
            has_eos=torch.full((b,), eos_token is not None, device=device),
            sampled=temperature != 0.0,
        )


@dataclasses.dataclass
class DecodeState:
    """What ``generate_decode`` continues from: the filled cache, the
    first sampled token, the next positions, EOS flags, the padding bias
    row [b, cache_len], the row generators and the token budget."""

    cache: KVCache
    token: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    pad_bias: torch.Tensor
    generators: Optional[List[torch.Generator]]
    budget: int


def _check_cache_len(model, prompt_len: int, max_new_tokens: int) -> int:
    # The cache holds exactly the tokens this call can produce.
    cache_len = prompt_len + max_new_tokens
    if cache_len > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt_len ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"= {cache_len} exceeds max_seq_len {model.cfg.max_seq_len}"
        )
    return cache_len


def prompt_positions(prompt_mask: torch.Tensor):
    """(positions [b, L], lengths [b]) of a right-padded prompt: positions
    are cumsum(mask) - 1 clipped at 0."""
    positions = (torch.cumsum(prompt_mask.long(), dim=-1) - 1).clamp_min(0)
    return positions, prompt_mask.sum(dim=-1)


def pad_bias_rows(prompt_mask: torch.Tensor, cache_len: int) -> torch.Tensor:
    """[b, cache_len] f32: -1e30 on the prompt's padding slots (they hold
    garbage K/V after prefill), 0 elsewhere; decode tokens land at slots
    >= prompt_len, which stay visible."""
    b, prompt_len = prompt_mask.shape
    slot_valid = torch.cat([prompt_mask, torch.ones(
        b, cache_len - prompt_len, dtype=torch.bool,
        device=prompt_mask.device)], dim=-1)
    return torch.where(slot_valid, 0.0, NEG_INF).float()


def _prefill_parts(model, prompt, prompt_mask, cache_len, rows: SamplingRows,
                   generators) -> DecodeState:
    """Prefill over the padded prompt: fill the cache, sample each row's
    first token from its last valid position."""
    b, prompt_len = prompt.shape
    if prompt_mask is None:
        prompt_mask = torch.ones(b, prompt_len, dtype=torch.bool,
                                 device=prompt.device)
    prompt_mask = prompt_mask.bool()
    positions, lengths = prompt_positions(prompt_mask)
    pad_bias = pad_bias_rows(prompt_mask, cache_len)
    cache = model.new_cache(b, cache_len)
    last_logits = model(prompt, positions=positions, cache=cache,
                        pad_bias=pad_bias, logits_at=lengths - 1)
    first = sample_logits_rows(last_logits, temps=rows.temps,
                               top_ks=rows.top_ks, sampled=rows.sampled,
                               generators=generators)
    done = rows.has_eos & (first == rows.eos_ids)
    return DecodeState(cache=cache, token=first, pos=lengths, done=done,
                       pad_bias=pad_bias, generators=generators,
                       budget=cache_len - prompt_len)


def decode_step(model, state: DecodeState, rows: SamplingRows, *,
                cache_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step over every row: apply the model on the current
    token, sample per row, freeze rows past their EOS.  Advances
    ``state`` in place and returns the new token [b].

    ``cache_slots`` [b] is the slot pool's form: row r writes its K/V at
    slot ``cache_slots[r]`` and sees slots <= it (plus its ``pad_bias``
    row) instead of the shared ``cache.index``.  Every op is
    row-independent, so a row steps alike in either form."""
    logits = model(state.token[:, None], positions=state.pos[:, None],
                   cache=state.cache, pad_bias=state.pad_bias,
                   cache_slots=cache_slots)
    nxt = sample_logits_rows(logits[:, -1], temps=rows.temps,
                             top_ks=rows.top_ks, sampled=rows.sampled,
                             generators=state.generators)
    nxt = torch.where(state.done & rows.has_eos, rows.eos_ids, nxt)
    state.done = state.done | (rows.has_eos & (nxt == rows.eos_ids))
    state.token = nxt
    state.pos = state.pos + 1
    return nxt


def generate_prefill(model, prompt: torch.Tensor, *,
                     prompt_mask: Optional[torch.Tensor] = None,
                     max_new_tokens: int = 32, temperature: float = 0.0,
                     top_k: Optional[int] = None,
                     eos_token: Optional[int] = None,
                     generators: Optional[List[torch.Generator]] = None):
    """Phase 1: the prompt pass alone.  Returns ``(first_token [b],
    decode_state)``; hand the state to ``generate_decode``.
    ``generators`` (one per row) default to ``row_generators(0, b)``."""
    b = prompt.shape[0]
    if generators is None:
        generators = row_generators(0, b, prompt.device)
    rows = SamplingRows.make(b, prompt.device, temperature, top_k, eos_token)
    cache_len = _check_cache_len(model, prompt.shape[1], max_new_tokens)
    with torch.inference_mode():
        state = _prefill_parts(model, prompt, prompt_mask, cache_len, rows,
                               generators)
    return state.token, state


def generate_decode(model, state: DecodeState, *,
                    max_new_tokens: Optional[int] = None,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    eos_token: Optional[int] = None) -> torch.Tensor:
    """Phase 2: the decode loop from a ``generate_prefill`` state.
    Returns [b, max_new_tokens] (first token included).  A budget other
    than the one the prefill sized its cache for raises."""
    if max_new_tokens is None:
        max_new_tokens = state.budget
    elif max_new_tokens != state.budget:
        raise ValueError(
            f"max_new_tokens {max_new_tokens} does not match the budget "
            f"the prefill sized its cache for ({state.budget})")
    b = state.token.shape[0]
    rows = SamplingRows.make(b, state.token.device, temperature, top_k,
                             eos_token)
    out = [state.token]
    with torch.inference_mode():
        for _ in range(max_new_tokens - 1):
            out.append(decode_step(model, state, rows))
    return torch.stack(out, dim=1)


def generate(model, prompt: torch.Tensor, *,
             prompt_mask: Optional[torch.Tensor] = None,
             max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: Optional[int] = None, eos_token: Optional[int] = None,
             generators: Optional[List[torch.Generator]] = None
             ) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of a [b, prompt_len]
    right-padded prompt (``prompt_mask`` True on real tokens).  Returns
    [b, max_new_tokens]; after an EOS a row pads with EOS."""
    kw = dict(temperature=temperature, top_k=top_k, eos_token=eos_token)
    _, state = generate_prefill(model, prompt, prompt_mask=prompt_mask,
                                max_new_tokens=max_new_tokens,
                                generators=generators, **kw)
    return generate_decode(model, state, **kw)
