"""Llama-family decoder in PyTorch — counterpart of
``kubeflow_tpu/models/llama.py``.

GQA + RoPE (half-split) + RMSNorm + SwiGLU, ``lm_head`` in f32; with
``n_experts`` > 0 (the Mixtral configs) every layer's MLP is a top-k
routed mixture of SwiGLU experts (``models/moe.py``).  The
parameter names follow the reference's tree (``models/convert.py`` maps
one onto the other).  Every op with a CUDA kernel (RMSNorm, causal flash
attention forward and backward, flash decode) routes through ``cfg.impl``:
"auto" takes the kernels on the card and the plain versions on the CPU.
Training stores f32 parameters (``param_dtype``) and computes in
``dtype``; ``remat`` recomputes a block or its MLP in the backward
(``torch.utils.checkpoint``, the reference's ``nn.remat``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.layers import (
    Attention,
    Embed,
    KVCache,
    Linear,
    PagedKVCache,
    PagedSlots,
    PagedView,
    RMSNorm,
    SwiGLU,
)
from kubeflow_tpu_torch.models.moe import MoeMlp
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.parallel import sharding
from kubeflow_tpu_torch.parallel.context import sequence_offset

NEG_INF = -1e30


def _remat(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` under ``torch.utils.checkpoint``, with
    the parameters it runs with passed in explicitly.  The backward's
    recompute runs after a caller's ``torch.func.functional_call`` has put
    the module's own parameters back (``train/steps.py`` differentiates
    bf16 copies of the f32 masters): it must see the tensors the forward
    saw, not the masters."""
    params = dict(module.named_parameters())
    return checkpoint(
        lambda p, *a: torch.func.functional_call(module, p, a, kwargs),
        params, *args, use_reentrant=False)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Storage dtype of the parameters (None: ``dtype``); training keeps the
    # f32 master weights the reference keeps (flax param_dtype).
    param_dtype: Optional[torch.dtype] = None
    # With remat: "block" recomputes the whole layer in the backward, "mlp"
    # only the SwiGLU (the reference's llama.py:41-49).
    remat: bool = False
    remat_mode: str = "block"
    # "auto" | "kernel" | "plain": routes RMSNorm and attention (ops/).
    impl: str = "auto"
    # MoE (Mixtral-style): n_experts == 0 means a dense SwiGLU MLP.
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.remat_mode not in ("block", "mlp"):
            raise ValueError("remat_mode must be 'block' or 'mlp', got "
                             f"{self.remat_mode!r}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# The reference's registry names and shapes.
CONFIGS = {
    "llama_debug": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=256, dtype=torch.float32,
    ),
    "llama_125m": LlamaConfig(
        vocab_size=32000, dim=768, n_layers=12, n_heads=12, n_kv_heads=12,
        ffn_dim=2048,
    ),
    "llama_1b4": LlamaConfig(
        vocab_size=32000, dim=2048, n_layers=24, n_heads=16, n_kv_heads=16,
        ffn_dim=5632,
    ),
    "llama2_7b": LlamaConfig(),
    "llama2_13b": LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                              ffn_dim=13824),
    "llama3_8b": LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, ffn_dim=14336,
                             rope_theta=500000.0, max_seq_len=8192),
    "mixtral_debug": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=256, dtype=torch.float32, n_experts=4,
    ),
    "mixtral_8x7b": LlamaConfig(
        dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, ffn_dim=14336,
        max_seq_len=32768, rope_theta=1000000.0, n_experts=8, top_k=2,
    ),
}


SEQUENCE_PARALLEL = ("ring", "ulysses")
# The projections models/layers.py runs tensor-parallel (Attention, SwiGLU).
TP_LOCAL = (r".*(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)"
            r"\.weight")
# The MoE experts models/moe.py computes as their ep shards.
EP_LOCAL = r".*\.(w_gate|w_up|w_down)"


def _norm_impl(impl: str) -> str:
    """The RMSNorm route for a config's ``impl``: the sequence-parallel
    attention routes leave the norms on "auto"."""
    return "auto" if impl in SEQUENCE_PARALLEL else impl


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, eps=cfg.norm_eps,
                                 impl=_norm_impl(cfg.impl), device=device)
        self.attn = Attention(
            cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_theta=cfg.rope_theta, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, impl=cfg.impl, device=device)
        self.mlp_norm = RMSNorm(cfg.dim, eps=cfg.norm_eps,
                                impl=_norm_impl(cfg.impl), device=device)
        self.moe = cfg.n_experts > 0
        if self.moe:
            self.mlp = MoeMlp(cfg.dim, cfg.ffn_dim, cfg.n_experts,
                              top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                              device=device)
        else:
            self.mlp = SwiGLU(cfg.dim, cfg.ffn_dim, dtype=cfg.dtype,
                              param_dtype=cfg.param_dtype, device=device)
        self.remat_mlp = cfg.remat and cfg.remat_mode == "mlp"

    def forward(self, x, positions, *, segment_ids=None, cache=None,
                layer=0, bias_rows=None, cache_slots=None, token_mask=None):
        """``(x, aux)``: the block's output and, for an MoE block, its
        load-balancing loss (None for a dense block)."""
        h = self.attn(self.attn_norm(x), positions, segment_ids=segment_ids,
                      cache=cache, layer=layer, bias_rows=bias_rows,
                      cache_slots=cache_slots)
        x = x + h
        h = self.mlp_norm(x)
        kw = {"token_mask": token_mask} if self.moe else {}
        if self.remat_mlp and torch.is_grad_enabled():
            h = _remat(self.mlp, h, **kw)
        else:
            h = self.mlp(h, **kw)
        aux = None
        if self.moe:
            h, aux = h
        return x + h, aux


class Llama(nn.Module):
    """The decoder, dense or MoE.  Parameters are uninitialised after
    construction: call ``reset_parameters(generator)`` or
    ``load_state_dict``."""

    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.dim, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, device=device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, eps=cfg.norm_eps,
                                  impl=_norm_impl(cfg.impl), device=device)
        # The reference computes the head in f32 (dtype=jnp.float32).
        self.lm_head = Linear(cfg.dim, cfg.vocab_size, dtype=torch.float32,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def tp_local(self, name: str) -> bool:
        """Whether parameter ``name`` is computed with as its ``tp`` shard
        under a mesh (``parallel/train.py`` then hands it over ungathered
        on ``tp``): the attention and SwiGLU projections."""
        return re.fullmatch(TP_LOCAL, name) is not None

    def ep_local(self, name: str) -> bool:
        """Whether parameter ``name`` is computed with as its ``ep`` shard
        under a mesh: the MoE experts (``models/moe.py`` sends each
        expert's tokens to the process that holds it)."""
        return re.fullmatch(EP_LOCAL, name) is not None

    def local_kv_heads(self) -> int:
        """The K/V heads this process computes: ``n_kv_heads / tp`` when
        the projections hold a ``tp`` shard, else ``n_kv_heads``."""
        proj = self.layers[0].attn.k_proj
        w = sharding.stored(proj, "weight")
        if w is None:
            w = proj.qweight
        return w.shape[0] // self.cfg.head_dim

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's flax initialisers, drawn from ``generator`` on
        the parameters' device."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def new_cache(self, batch: int, length: int) -> KVCache:
        cfg = self.cfg
        if length > cfg.max_seq_len:
            raise ValueError(
                f"cache_len {length} exceeds max_seq_len {cfg.max_seq_len}")
        return KVCache.empty(cfg.n_layers, batch, length,
                             self.local_kv_heads(), cfg.head_dim,
                             dtype=cfg.dtype, device=self.device)

    def new_paged_cache(self, pool_positions: int, *,
                        shard: Optional[tuple] = None,
                        groups: tuple = ()) -> PagedKVCache:
        """The paged engine's pool: zeros, [pool_positions, kv_h, d] a
        layer in the model's dtype, kv_h this process's K/V heads; with
        the data axes' ``groups``, only the positions ``shard`` = (first,
        count) (``PagedKVCache``)."""
        cfg = self.cfg
        return PagedKVCache.empty(cfg.n_layers, pool_positions,
                                  self.local_kv_heads(), cfg.head_dim,
                                  dtype=cfg.dtype, device=self.device,
                                  shard=shard, groups=groups)

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[Union[KVCache, PagedKVCache]] = None,
                pad_bias: Optional[torch.Tensor] = None,
                cache_slots=None,
                logits_at: Optional[torch.Tensor] = None,
                return_hidden: bool = False,
                token_mask: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        """Logits [b, s, vocab] f32, or [b, vocab] at the per-row
        positions ``logits_at`` [b] (the head then runs on those rows only),
        or with ``return_hidden`` the final-normed hidden states [b, s, dim]
        without the head (the caller applies it per chunk:
        ``train/steps.py`` ``chunked_cross_entropy``).

        With ``cache``, the call writes its K/V at ``cache.index`` and
        advances it.  A single-token call attends over the whole cache
        with one bias row per batch row, built here once per step (not
        once per layer): slot j is visible iff j <= cache.index, plus
        ``pad_bias`` [b, length] (0 or -1e30) hiding prompt padding.
        With ``cache_slots`` [b] (a single-token call; the slot pool of
        ``models/scheduler.py``) row r writes at slot ``cache_slots[r]``
        and sees slot j iff j <= cache_slots[r], plus its ``pad_bias``
        row; ``cache.index`` does not move.

        With a ``PagedKVCache`` and ``cache_slots`` a ``PagedSlots`` (the
        paged engine, ``models/paged.py``), the pool positions to write and
        read come resolved through the page tables.  Token t of row r sees
        logical slot j iff j <= ``slots[r, t]``, plus its ``pad_bias`` row
        [b, L]; a prefill chunk (``prefix_len`` set) is causal over the
        first prefix_len + s slots instead.  The bias and the flat read
        indices are built here once a step.

        ``token_mask`` [b, s] (True on real tokens) keeps padding out of
        an MoE model's expert routing (the prompt pass passes the prompt
        mask).  With ``return_aux`` the call returns ``(output, aux)``,
        aux the MoE load-balancing loss averaged over layers (0 for a
        dense model), the reference's mean of its sowed losses."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
            if self.cfg.impl in SEQUENCE_PARALLEL:
                # Under ring or Ulysses attention ``tokens`` is this rank's
                # chunk of the sequence: its positions are global.
                positions = positions + sequence_offset(s)
        bias_rows = None
        if isinstance(cache_slots, PagedSlots) or isinstance(
                cache, PagedKVCache):
            bias_rows, cache_slots = self._paged_view(
                cache, cache_slots, pad_bias, b, s)
        elif cache_slots is not None and (cache is None or s != 1):
            raise ValueError("cache_slots need a cache and one token a row")
        elif cache is not None and s == 1:
            slots = torch.arange(cache.length, device=tokens.device)
            if cache_slots is not None:
                visible = slots[None, :] <= cache_slots[:, None]
            else:
                visible = (slots <= cache.index)[None].expand(b, -1)
            bias_rows = torch.where(visible, 0.0, NEG_INF).float()
            if pad_bias is not None:
                bias_rows = bias_rows + pad_bias
            bias_rows = bias_rows.contiguous()
        x = self.embed(tokens)
        remat_block = (self.cfg.remat and self.cfg.remat_mode == "block"
                       and cache is None and torch.is_grad_enabled())
        auxes = []
        for i, block in enumerate(self.layers):
            if remat_block:
                x, aux = _remat(block, x, positions, segment_ids=segment_ids,
                                token_mask=token_mask)
            else:
                x, aux = block(x, positions, segment_ids=segment_ids,
                               cache=cache, layer=i, bias_rows=bias_rows,
                               cache_slots=cache_slots, token_mask=token_mask)
            if aux is not None:
                auxes.append(aux)
        if cache is not None and cache_slots is None:
            cache.index += s
        if return_hidden:
            out = self.final_norm(x)
        else:
            if logits_at is not None:
                x = x[torch.arange(b, device=x.device), logits_at][:, None]
            out = self.lm_head(self.final_norm(x))
            if logits_at is not None:
                out = out[:, 0]
        if not return_aux:
            return out
        aux = (torch.stack(auxes).mean() if auxes
               else x.new_zeros((), dtype=torch.float32))
        return out, aux

    @staticmethod
    def _paged_view(cache, ps, pad_bias, b: int, s: int):
        """(bias, PagedView) of a paged step: bias rows [b, L] for a
        single-token step, [b, 1, s, L] for a verify pass, None for a
        prefill chunk."""
        if not (isinstance(cache, PagedKVCache)
                and isinstance(ps, PagedSlots)):
            raise ValueError("a paged call needs a PagedKVCache and "
                             "PagedSlots together")
        if ps.pool_positions != cache.pool_positions or tuple(
                ps.write.shape) != (b, s):
            raise ValueError(
                f"PagedSlots write {tuple(ps.write.shape)} over a pool of "
                f"{ps.pool_positions} positions does not fit the call "
                f"({b}, {s}) or the cache ({cache.pool_positions})")
        if ps.prefix_len is not None:
            length = ps.prefix_len + s
            if length > ps.read.shape[1]:
                raise ValueError(f"prefill chunk ends at slot {length}, past "
                                 f"the rows' {ps.read.shape[1]} slots")
            read = ps.read[:, :length].reshape(-1)
            return None, PagedView(ps.write.reshape(-1), read, length, True)
        length = ps.read.shape[1]
        slots = torch.arange(length, device=ps.read.device)
        visible = slots[None, None, :] <= ps.slots[:, :, None]
        bias = torch.where(visible, 0.0, NEG_INF).float()
        if pad_bias is not None:
            bias = bias + pad_bias[:, None, :]
        bias = bias[:, 0].contiguous() if s == 1 else bias[:, None]
        return bias, PagedView(ps.write.reshape(-1), ps.read.reshape(-1),
                               length, False)


def _factory(name):
    @register_model(name)
    def make(*, device=None, **overrides):
        return Llama(dataclasses.replace(CONFIGS[name], **overrides),
                     device=device)

    make.__name__ = name
    return make


for _n in CONFIGS:
    _factory(_n)
