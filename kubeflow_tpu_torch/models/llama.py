"""Llama-family decoder in PyTorch — counterpart of
``kubeflow_tpu/models/llama.py`` (dense configs only).

GQA + RoPE (half-split) + RMSNorm + SwiGLU, ``lm_head`` in f32.  The
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
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.models.layers import (
    Attention,
    Embed,
    KVCache,
    Linear,
    RMSNorm,
    SwiGLU,
)
from kubeflow_tpu_torch.models.registry import register_model

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
    # MoE (Mixtral-style) is not ported: n_experts > 0 raises in Llama.
    n_experts: int = 0

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
        max_seq_len=32768, rope_theta=1000000.0, n_experts=8,
    ),
}


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, eps=cfg.norm_eps, impl=cfg.impl,
                                 device=device)
        self.attn = Attention(
            cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            rope_theta=cfg.rope_theta, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, impl=cfg.impl, device=device)
        self.mlp_norm = RMSNorm(cfg.dim, eps=cfg.norm_eps, impl=cfg.impl,
                                device=device)
        self.mlp = SwiGLU(cfg.dim, cfg.ffn_dim, dtype=cfg.dtype,
                          param_dtype=cfg.param_dtype, device=device)
        self.remat_mlp = cfg.remat and cfg.remat_mode == "mlp"

    def forward(self, x, positions, *, segment_ids=None, cache=None,
                layer=0, bias_rows=None, cache_slots=None):
        h = self.attn(self.attn_norm(x), positions, segment_ids=segment_ids,
                      cache=cache, layer=layer, bias_rows=bias_rows,
                      cache_slots=cache_slots)
        x = x + h
        h = self.mlp_norm(x)
        if self.remat_mlp and torch.is_grad_enabled():
            return x + _remat(self.mlp, h)
        return x + self.mlp(h)


class Llama(nn.Module):
    """The dense decoder.  Parameters are uninitialised after
    construction: call ``reset_parameters(generator)`` or
    ``load_state_dict``."""

    def __init__(self, cfg: LlamaConfig, *, device=None):
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "MoE (n_experts > 0) is not ported yet; see ROADMAP.md")
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.dim, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, device=device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, eps=cfg.norm_eps, impl=cfg.impl,
                                  device=device)
        # The reference computes the head in f32 (dtype=jnp.float32).
        self.lm_head = Linear(cfg.dim, cfg.vocab_size, dtype=torch.float32,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

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
        return KVCache.empty(cfg.n_layers, batch, length, cfg.n_kv_heads,
                             cfg.head_dim, dtype=cfg.dtype,
                             device=self.device)

    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                pad_bias: Optional[torch.Tensor] = None,
                cache_slots: Optional[torch.Tensor] = None,
                logits_at: Optional[torch.Tensor] = None,
                return_hidden: bool = False) -> torch.Tensor:
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
        row; ``cache.index`` does not move."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        if cache_slots is not None and (cache is None or s != 1):
            raise ValueError("cache_slots need a cache and one token a row")
        bias_rows = None
        if cache is not None and s == 1:
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
        for i, block in enumerate(self.layers):
            if remat_block:
                x = _remat(block, x, positions, segment_ids=segment_ids)
            else:
                x = block(x, positions, segment_ids=segment_ids, cache=cache,
                          layer=i, bias_rows=bias_rows,
                          cache_slots=cache_slots)
        if cache is not None and cache_slots is None:
            cache.index += s
        if return_hidden:
            return self.final_norm(x)
        if logits_at is not None:
            x = x[torch.arange(b, device=x.device), logits_at][:, None]
        logits = self.lm_head(self.final_norm(x))
        return logits[:, 0] if logits_at is not None else logits


def _factory(name):
    @register_model(name)
    def make(*, device=None, **overrides):
        return Llama(dataclasses.replace(CONFIGS[name], **overrides),
                     device=device)

    make.__name__ = name
    return make


for _n in CONFIGS:
    _factory(_n)
