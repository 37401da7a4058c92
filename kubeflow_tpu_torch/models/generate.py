"""Autoregressive generation with a KV cache — counterpart of
``kubeflow_tpu/models/generate.py``.

* **Prefill** runs the whole right-padded prompt in one pass, writing the
  cache at index 0 (causal flash attention over the fresh tokens).
* **Decode** is a Python loop of single-token steps; every step writes
  its K/V at the shared scalar cache index and attends over the whole
  cache with one bias row per batch row (``Llama.forward``).  The same
  step body (``decode_step``) drives the continuous-batching slot pool
  (``models/scheduler.py``), with a per-row write slot instead, and the
  paged engine's (``models/paged.py``), through page tables.
* Sampling is per row: row i draws its Gumbel noise from its own
  ``torch.Generator``, so a row's stream depends on its generator only.
  A caller (a parity test) may inject the noise instead.  Under a mesh
  every process runs the same calls with the same per-row generators on
  bit-equal logits (the head is whole on every process, and an
  all-reduce leaves each the same sum), so every process samples the
  same token and none is broadcast.
* **Encoder-decoder** models (T5: ``encode``/``decode``) generate with
  ``generate_seq2seq``: the source is encoded once, then cached decoder
  steps run from BOS.
* **Beam search** (``beam_search_seq2seq``, and ``beam_search`` for a
  decoder) folds the beams into the batch, keeps the best ``beams`` of
  every beam's continuations a step, re-gathers the self-attention cache
  after the surviving beams' parents, and ranks the finished sequences
  with GNMT's length normalisation.

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


def sample_first(last_logits: torch.Tensor, rows: SamplingRows,
                 generators: Sequence[torch.Generator]):
    """``(first [b], done [b])``: each row's first token from the logits of
    its last valid prompt token [b, vocab], drawn from the row's generator,
    and whether it is the row's EOS.  The one recipe of every prefill: the
    lock path's, and the paged engine's, whose chunks accumulate the
    logits (``models/paged.py``), so a seeded request draws the same
    tokens on both."""
    first = sample_logits_rows(last_logits, temps=rows.temps,
                               top_ks=rows.top_ks, sampled=rows.sampled,
                               generators=generators)
    return first, rows.has_eos & (first == rows.eos_ids)


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
    # token_mask keeps padding out of an MoE model's expert routing.
    last_logits = model(prompt, positions=positions, cache=cache,
                        pad_bias=pad_bias, logits_at=lengths - 1,
                        token_mask=prompt_mask)
    first, done = sample_first(last_logits, rows, generators)
    return DecodeState(cache=cache, token=first, pos=lengths, done=done,
                       pad_bias=pad_bias, generators=generators,
                       budget=cache_len - prompt_len)


def decode_step(model, state: DecodeState, rows: SamplingRows, *,
                cache_slots=None) -> torch.Tensor:
    """One decode step over every row: apply the model on the current
    token, sample per row, freeze rows past their EOS.  Advances
    ``state`` in place and returns the new token [b].

    ``cache_slots`` [b] is the slot pool's form: row r writes its K/V at
    slot ``cache_slots[r]`` and sees slots <= it (plus its ``pad_bias``
    row) instead of the shared ``cache.index``; a ``PagedSlots`` is the
    paged engine's form (``state.cache`` a ``PagedKVCache``), with the
    write and read positions resolved through the page tables.  Every op
    is row-independent, so a row steps alike in each form."""
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


# -- encoder-decoder generation and beam search -----------------------------


def generate_seq2seq(model, source: torch.Tensor, *,
                     source_mask: Optional[torch.Tensor] = None,
                     max_new_tokens: int = 32, bos_token: int = 0,
                     eos_token: Optional[int] = 1, temperature: float = 0.0,
                     top_k: Optional[int] = None,
                     generators: Optional[List[torch.Generator]] = None
                     ) -> torch.Tensor:
    """Encoder-decoder generation (a model with ``encode``/``decode``, T5):
    encode the [b, src_len] source once, then run cached single-token
    decoder steps from ``bos_token`` (T5's pad id 0) over a cache of
    exactly ``max_new_tokens`` slots.  Returns [b, max_new_tokens]; after
    ``eos_token`` (T5's 1) a row pads with it.

    Sampling draws row i's noise from ``generators[i]`` (default
    ``row_generators(0, b)``), as the decoder-only path does, so a row's
    stream does not depend on the batch it shares.  The reference draws
    the whole batch's noise from one JAX key (``sample_logits``), a
    stream no torch generator reproduces: seeded samples differ from the
    reference's, greedy tokens do not."""
    b = source.shape[0]
    if generators is None:
        generators = row_generators(0, b, source.device)
    rows = SamplingRows.make(b, source.device, temperature, top_k, eos_token)
    if source_mask is not None:
        source_mask = source_mask.bool()
    with torch.inference_mode():
        encoded = model.encode(source, source_mask)
        cache = model.new_cache(b, max_new_tokens)
        token = torch.full((b,), bos_token, dtype=torch.long,
                           device=source.device)
        out, done = [], None
        for _ in range(max_new_tokens):
            logits = model.decode(encoded, token[:, None],
                                  source_mask=source_mask, cache=cache)
            token = sample_logits_rows(
                logits[:, -1], temps=rows.temps, top_ks=rows.top_ks,
                sampled=rows.sampled, generators=generators)
            if done is None:
                done = rows.has_eos & (token == rows.eos_ids)
            else:
                token = torch.where(done & rows.has_eos, rows.eos_ids, token)
                done = done | (rows.has_eos & (token == rows.eos_ids))
            out.append(token)
    return torch.stack(out, dim=1)


def top_k_lowest_index(x: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last axis, ties to
    the lowest index, as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among ties on the card): a stable descending
    sort."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _beam_loop(step_apply, logp0: torch.Tensor, cache, *, beams: int,
               eos_token: Optional[int], length_penalty: float,
               max_new_tokens: int) -> torch.Tensor:
    """The beam machinery both searches share: seed the beams from
    ``logp0`` [b, vocab]; for i = 1..T-1, ``step_apply(token [b, beams],
    i) -> logp [b, beams, vocab]`` runs the model one step on the cache
    (its rows beam-folded, [b * beams]); keep the best ``beams`` of
    ``beams * vocab`` continuations, re-gather the cache's self-attention
    K/V after their parents (never the cross-attention K/V, equal across
    a source's beams); backtrack the parent pointers and return the best
    sequence of each row [b, T] by score / ((5 + len) / 6)^length_penalty,
    len counting through the first EOS and capped at T.  A beam that
    emitted ``eos_token`` may only emit it again, at zero added score;
    ``eos_token=None`` searches by score alone."""
    b, vocab = logp0.shape
    dev = logp0.device
    scores, first = top_k_lowest_index(logp0, beams)
    if max_new_tokens == 1:
        return first[:, :1]
    alive = eos_only = None
    if eos_token is not None:
        alive = first != eos_token
        eos_only = torch.full((vocab,), float("-inf"), device=dev)
        eos_only[eos_token] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * beams
    token, toks, parents = first, [], []
    for i in range(1, max_new_tokens):
        logp = step_apply(token, i)
        if alive is not None:
            logp = torch.where(alive[..., None], logp, eos_only)
        total = scores[..., None] + logp
        scores, flat = top_k_lowest_index(total.reshape(b, beams * vocab),
                                          beams)
        parent = flat // vocab
        token = flat % vocab
        gather = (rows + parent).reshape(-1)
        cache.k = [t.index_select(0, gather) for t in cache.k]
        cache.v = [t.index_select(0, gather) for t in cache.v]
        if alive is not None:
            alive = alive.gather(1, parent) & (token != eos_token)
        toks.append(token)
        parents.append(parent)
    # Backtrack the parent pointers into whole sequences [b, beams, T].
    beam_idx = torch.arange(beams, device=dev).expand(b, beams)
    rev = []
    for tok_t, parent_t in zip(reversed(toks), reversed(parents)):
        rev.append(tok_t.gather(1, beam_idx))
        beam_idx = parent_t.gather(1, beam_idx)
    seqs = torch.stack([first.gather(1, beam_idx)] + rev[::-1], dim=2)
    T = seqs.shape[2]
    if eos_token is not None:
        before = torch.cumprod((seqs != eos_token).long(), dim=2)
        lengths = (before.sum(dim=2).float() + 1.0).clamp_max(float(T))
    else:
        lengths = torch.full((b, beams), float(T), device=dev)
    norm = ((5.0 + lengths) / 6.0) ** length_penalty
    best = torch.argmax(scores / norm, dim=1)
    return seqs[torch.arange(b, device=dev), best]


def beam_search_seq2seq(model, source: torch.Tensor, *,
                        source_mask: Optional[torch.Tensor] = None,
                        max_new_tokens: int = 32, beams: int = 4,
                        bos_token: int = 0, eos_token: int = 1,
                        length_penalty: float = 0.6) -> torch.Tensor:
    """Beam search for an encoder-decoder model: encode once, repeat the
    encoder output (and the mask) to the ``b * beams`` beam-folded rows,
    whose cached decoder steps run ``_beam_loop``.  Returns
    [b, max_new_tokens], each row's best beam."""
    b, src_len = source.shape
    if source_mask is None:
        source_mask = torch.ones(b, src_len, dtype=torch.bool,
                                 device=source.device)
    source_mask = source_mask.bool()
    with torch.inference_mode():
        encoded = model.encode(source, source_mask).repeat_interleave(
            beams, dim=0)
        mask_r = source_mask.repeat_interleave(beams, dim=0)
        cache = model.new_cache(b * beams, max_new_tokens)
        tok0 = torch.full((b * beams, 1), bos_token, dtype=torch.long,
                          device=source.device)
        logits = model.decode(encoded, tok0, source_mask=mask_r, cache=cache)
        logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
        vocab = logp0.shape[-1]
        # Every beam of a row starts from BOS: seed from the first.
        logp0 = logp0.view(b, beams, vocab)[:, 0]

        def step_apply(token, i):
            del i                               # the cache holds the step
            logits = model.decode(encoded, token.reshape(b * beams, 1),
                                  source_mask=mask_r, cache=cache)
            return torch.log_softmax(logits[:, -1].float(), dim=-1).view(
                b, beams, vocab)

        return _beam_loop(step_apply, logp0, cache, beams=beams,
                          eos_token=eos_token, length_penalty=length_penalty,
                          max_new_tokens=max_new_tokens)


def beam_search(model, prompt: torch.Tensor, *,
                prompt_mask: Optional[torch.Tensor] = None,
                max_new_tokens: int = 32, beams: int = 4,
                eos_token: Optional[int] = None,
                length_penalty: float = 0.6) -> torch.Tensor:
    """Beam search for a decoder: one prefill over the right-padded prompt
    with its padding bias (``generate``'s contract), then the cache, the
    padding bias and the prompt lengths tiled to ``b * beams`` rows; step
    i feeds each beam's last token at position ``lengths + i - 1``.
    Returns [b, max_new_tokens], each row's best beam."""
    b, prompt_len = prompt.shape
    cache_len = _check_cache_len(model, prompt_len, max_new_tokens)
    if prompt_mask is None:
        prompt_mask = torch.ones(b, prompt_len, dtype=torch.bool,
                                 device=prompt.device)
    prompt_mask = prompt_mask.bool()
    positions, lengths = prompt_positions(prompt_mask)
    pad_bias = pad_bias_rows(prompt_mask, cache_len)
    with torch.inference_mode():
        cache = model.new_cache(b, cache_len)
        last = model(prompt, positions=positions, cache=cache,
                     pad_bias=pad_bias, logits_at=lengths - 1,
                     token_mask=prompt_mask)
        logp0 = torch.log_softmax(last.float(), dim=-1)
        vocab = logp0.shape[-1]
        cache.k = [t.repeat_interleave(beams, dim=0) for t in cache.k]
        cache.v = [t.repeat_interleave(beams, dim=0) for t in cache.v]
        pad_bias_r = pad_bias.repeat_interleave(beams, dim=0)
        lengths_r = lengths.repeat_interleave(beams)

        def step_apply(token, i):
            logits = model(token.reshape(b * beams, 1),
                           positions=(lengths_r + i - 1)[:, None],
                           cache=cache, pad_bias=pad_bias_r)
            return torch.log_softmax(logits[:, -1].float(), dim=-1).view(
                b, beams, vocab)

        return _beam_loop(step_apply, logp0, cache, beams=beams,
                          eos_token=eos_token, length_penalty=length_penalty,
                          max_new_tokens=max_new_tokens)
