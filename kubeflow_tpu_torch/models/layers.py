"""Transformer building blocks (``torch.nn``), routed through
``kubeflow_tpu_torch.ops`` so every model picks up the CUDA kernels.

Counterpart of ``kubeflow_tpu/models/layers.py``.  Parameters are made
with ``torch.empty`` (no initialisation at construction, so an 8B model
is built on the card in moments); ``reset_parameters(generator)`` fills
them with the reference's flax initialisers, or ``load_state_dict`` with
converted weights (``models/convert.py``).

Each layer has a compute dtype and a storage dtype (``param_dtype``, by
default the compute dtype): the reference stores f32 parameters and casts
them to the compute dtype at use (flax ``param_dtype``, ``.astype`` at
``layers.py:74``).  Serving stores bf16, which gives the same values;
training stores the f32 master weights.  Parameters are made frozen
(``requires_grad=False``, what serving needs); a trainer unfreezes them
with ``module.requires_grad_(True)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import ops

# flax's truncated-normal initialisers divide the target std by the std
# of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal in [-2, 2] std, std
    sqrt(1 / fan_in).  Drawn in f32, then cast to the weight's dtype."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w32 = torch.empty(weight.shape, dtype=torch.float32, device=weight.device)
    nn.init.trunc_normal_(w32, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(w32)


class Linear(nn.Module):
    """Bias-free ``y = x @ W.T`` with W [out, in] (``nn.Linear``'s layout,
    uninitialised at construction), computed in ``dtype`` from W stored in
    ``param_dtype``."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype or dtype,
            device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Embed(nn.Module):
    """Token embedding; flax init variance_scaling(1, fan_in, normal,
    out_axis=0), i.e. normal with std sqrt(1 / features)."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(
            num_embeddings, features, dtype=param_dtype or dtype,
            device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        w32 = torch.empty(self.embedding.shape, dtype=torch.float32,
                          device=self.embedding.device)
        w32.normal_(0.0, math.sqrt(1.0 / self.features), generator=generator)
        with torch.no_grad():
            self.embedding.copy_(w32)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding.to(self.dtype))


class RMSNorm(nn.Module):
    """RMSNorm with an f32 scale (ones at init) over ``ops.rms_norm``; a
    scale in another dtype (a bf16 copy differentiated for bf16 gradients)
    goes to the op as it is, which casts it to f32 inside, as the
    reference's kernel does, and returns its gradient in that dtype."""

    def __init__(self, dim: int, *, eps: float = 1e-6, impl: str = "auto",
                 device=None):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.scale = nn.Parameter(
            torch.empty(dim, dtype=torch.float32, device=device),
            requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rms_norm(x, self.scale, eps=self.eps, impl=self.impl)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings, BSHD input, pairing (x[..., :d/2], x[..., d/2:])
    — half-split, as the reference does, not the interleaved HF/Meta
    pairing.  Computed in f32, returned in ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs            # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V buffers [b, length, kv_h, d], sequence-major, plus the
    scalar write index every layer shares (the reference's flax
    ``cache_index``).  The buffers are updated in place: unlike the
    reference's functional cache, a step costs no cache copy."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: int = 0

    @classmethod
    def empty(cls, n_layers: int, batch: int, length: int, kv_heads: int,
              head_dim: int, *, dtype: torch.dtype, device) -> "KVCache":
        shape = (batch, length, kv_heads, head_dim)
        return cls(
            k=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(n_layers)],
            v=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(n_layers)],
        )

    @property
    def length(self) -> int:
        return self.k[0].shape[1]


class Attention(nn.Module):
    """Grouped-query self-attention with RoPE over ``ops``.

    Without a cache: causal attention over the sequence (``segment_ids``
    masks packed documents).  With a ``KVCache`` (scalar-index mode): the
    new K/V are written at ``cache.index``; a multi-token call at index 0
    (prefill) attends causally over the fresh q/k/v only, and a
    single-token call (decode) attends over the whole cache with the
    caller's bias row [b, length] (causal + padding).  With
    ``cache_slots`` [b] (per-row mode, single-token only): row r writes
    its K/V at slot ``cache_slots[r]`` and the caller's bias rows carry
    the whole per-row visibility (the continuous-batching slot pool,
    whose rows sit at different depths)."""

    def __init__(self, dim: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, *, rope_theta: float, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 impl: str = "auto", device=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.impl = impl
        lin = lambda i, o: Linear(i, o, dtype=dtype, param_dtype=param_dtype,
                                  device=device)
        self.q_proj = lin(dim, num_heads * head_dim)
        self.k_proj = lin(dim, num_kv_heads * head_dim)
        self.v_proj = lin(dim, num_kv_heads * head_dim)
        self.o_proj = lin(num_heads * head_dim, dim)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, layer: int = 0,
                bias_rows: Optional[torch.Tensor] = None,
                cache_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        q = apply_rope(q, positions, theta=self.rope_theta)
        k = apply_rope(k, positions, theta=self.rope_theta)
        if cache is None:
            out = ops.dot_product_attention(
                q, k, v, causal=True, segment_ids=segment_ids,
                impl=self.impl)
        else:
            if segment_ids is not None:
                raise ValueError(
                    "the KV cache holds one sequence per batch row; "
                    "segment_ids (packed sequences) are not supported")
            k_buf, v_buf = cache.k[layer], cache.v[layer]
            if cache_slots is not None:
                if s != 1:
                    raise ValueError(
                        "per-row cache_slots require single-token decode, "
                        f"got s={s}")
                if bias_rows is None:
                    raise ValueError("per-row cache_slots need bias_rows")
                rows = torch.arange(b, device=x.device)
                k_buf[rows, cache_slots] = k[:, 0]
                v_buf[rows, cache_slots] = v[:, 0]
                out = ops.decode_attention(q, k_buf, v_buf, bias_rows,
                                           impl=self.impl)
                return self.o_proj(
                    out.reshape(b, s, self.num_heads * self.head_dim))
            idx = cache.index
            if idx + s > cache.length:
                raise ValueError(
                    f"cache of {cache.length} slots cannot take {s} tokens "
                    f"at index {idx}")
            k_buf[:, idx:idx + s] = k
            v_buf[:, idx:idx + s] = v
            if s == 1:
                if bias_rows is None:
                    raise ValueError("single-token decode needs bias_rows")
                out = ops.decode_attention(q, k_buf, v_buf, bias_rows,
                                           impl=self.impl)
            elif idx == 0:
                # Prefill: a valid query row never sees a pad or unwritten
                # slot under the causal mask of right-padded prompts, so
                # attending over the fresh tokens equals the reference's
                # cached-bias prefill on every valid row.
                out = ops.dot_product_attention(q, k, v, causal=True,
                                                impl=self.impl)
            else:
                raise NotImplementedError(
                    "multi-token steps at a cache index > 0 (chunked "
                    "prefill) are not ported yet; see ROADMAP.md")
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, *, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        lin = lambda i, o: Linear(i, o, dtype=dtype, param_dtype=param_dtype,
                                  device=device)
        self.gate_proj = lin(dim, hidden_dim)
        self.up_proj = lin(dim, hidden_dim)
        self.down_proj = lin(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
