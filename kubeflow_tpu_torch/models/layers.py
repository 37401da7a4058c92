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
with ``module.requires_grad_(True)``.  ``Linear`` and ``Embed`` can be
quantized to int8 for serving (``models/quantize.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch import ops
from kubeflow_tpu_torch.models import quantize
from kubeflow_tpu_torch.parallel import sharding

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
    """``y = x @ W.T`` with W [out, in] (``nn.Linear``'s layout,
    uninitialised at construction), computed in ``dtype`` from W stored in
    ``param_dtype``, or, once quantized (``models/quantize.py``), from the
    int8 buffer ``qweight`` and its f32 ``scale``, dequantized at each
    call (``weight`` is then None).  ``out_block`` > 0 marks an output
    axis that the reference splits as (out / out_block, out_block), q/k/v
    by heads: its scales are then one per out_block index, not per row.
    With ``bias`` it is flax's ``nn.Dense`` with a bias (zeros at init),
    added in the compute dtype; without, the bias-free ``DenseGeneral``."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, param_dtype: Optional[torch.dtype] = None,
                 out_block: int = 0, bias: bool = False, device=None):
        super().__init__()
        self.in_features = in_features
        self.dtype = dtype
        self.out_block = out_block
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=param_dtype or dtype,
            device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(
            out_features, dtype=param_dtype or dtype, device=device),
            requires_grad=False) if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.weight is not None:
            lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _blocks(self, w: torch.Tensor) -> torch.Tensor:
        """W [out, in] as the reference splits its output axis."""
        if not self.out_block:
            return w
        return w.view(-1, self.out_block, self.in_features)

    def quantize_(self, source: Optional[torch.Tensor] = None) -> None:
        """Replace W by int8 values and f32 scales over the reference's
        axes (``quantize.quantize_tensor``), from ``source`` (the same
        weight in another dtype, e.g. a checkpoint's f32) or W itself;
        W is freed."""
        w = self._blocks(self.weight if source is None else source)
        dims = (0, 2) if self.out_block else (1,)
        q, scale = quantize.quantize_tensor(w.to(self.weight.device), dims)
        self.weight = None
        self.register_buffer("qweight", q.view(-1, self.in_features))
        self.register_buffer("scale", scale)

    def dense_weight(self) -> torch.Tensor:
        """W in the compute dtype (dequantized when quantized).  W is read
        once: under a mesh a read may gather it
        (``sharding.GatherAtUse``)."""
        w = self.weight
        if w is not None:
            return w.to(self.dtype)
        w = quantize.dequantize(self._blocks(self.qweight), self.scale,
                                self.dtype)
        return w.view(self.qweight.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.dense_weight(), bias)


class Embed(nn.Module):
    """Token embedding; flax init variance_scaling(1, fan_in, normal,
    out_axis=0), i.e. normal with std sqrt(1 / features).  Once quantized
    the table is int8 ``qweight`` with one f32 scale a column, and the
    looked-up rows are dequantized (``embedding`` is then None)."""

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
        if self.embedding is None:
            return
        w32 = torch.empty(self.embedding.shape, dtype=torch.float32,
                          device=self.embedding.device)
        w32.normal_(0.0, math.sqrt(1.0 / self.features), generator=generator)
        with torch.no_grad():
            self.embedding.copy_(w32)

    def quantize_(self, source: Optional[torch.Tensor] = None) -> None:
        """As ``Linear.quantize_``, one scale a column (the reference
        reduces the vocabulary axis)."""
        w = self.embedding if source is None else source
        q, scale = quantize.quantize_tensor(w.to(self.embedding.device), (0,))
        self.embedding = None
        self.register_buffer("qweight", q)
        self.register_buffer("scale", scale)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self.embedding     # read once (a read may gather it)
        if table is not None:
            return F.embedding(tokens, table.to(self.dtype))
        # Dequantizing is elementwise, so the looked-up rows alone give
        # the rows of the dequantized table.
        return quantize.dequantize(self.qweight[tokens], self.scale,
                                   self.dtype)


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


@dataclasses.dataclass
class PagedKVCache:
    """The paged engine's pool (``models/paged.py``): per layer, K and V of
    every row in one flat tensor [pool_positions, kv_h, d], pool_positions
    = num_pages x page_len.  A row's logical slots map to pool positions
    through its page table; page 0 is the null page, where unallocated
    logical pages point and idle lanes write, always behind the mask.
    Counterpart of the reference's ``paged_key``/``paged_value`` cache
    variables (``kubeflow_tpu/models/layers.py:274-306``).

    Under a mesh with data axes (``groups``, their process groups) the
    pool's positions split over them: this process holds the ``count``
    positions from ``first`` (``sharding.page_pool_spec``), plus one spare
    row that takes the writes of positions it does not own.  A write
    lands only at the owner; a read gathers each process's own positions,
    zeros elsewhere, and sums them over the data axes (``gather``), one
    collective a data axis and layer for K and V together."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    first: int = 0
    count: Optional[int] = None
    total: Optional[int] = None
    groups: tuple = ()

    @classmethod
    def empty(cls, n_layers: int, pool_positions: int, kv_heads: int,
              head_dim: int, *, dtype: torch.dtype, device,
              shard: Optional[tuple] = None,
              groups: tuple = ()) -> "PagedKVCache":
        first, count = shard if groups and shard else (0, pool_positions)
        rows = count + 1 if groups else count
        shape = (rows, kv_heads, head_dim)
        return cls(
            k=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(n_layers)],
            v=[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(n_layers)],
            first=first, count=count, total=pool_positions,
            groups=tuple(groups),
        )

    @property
    def pool_positions(self) -> int:
        return self.total if self.total is not None else self.k[0].shape[0]

    def _local(self, positions: torch.Tensor):
        """(local row of each position, whether this process owns it);
        a position it does not own maps to the spare row."""
        local = positions - self.first
        own = (local >= 0) & (local < self.count)
        return torch.where(own, local, self.count), own

    def write(self, layer: int, positions: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """K/V [n, kv_h, d] into the pool at ``positions`` [n]."""
        if self.groups:
            positions, _ = self._local(positions)
        self.k[layer].index_copy_(0, positions, k)
        self.v[layer].index_copy_(0, positions, v)

    def gather(self, layer: int, positions: torch.Tensor):
        """``(k, v)`` [n, kv_h, d] at the pool's ``positions`` [n]."""
        if not self.groups:
            return (self.k[layer].index_select(0, positions),
                    self.v[layer].index_select(0, positions))
        local, own = self._local(positions)
        kv = torch.stack([self.k[layer].index_select(0, local),
                          self.v[layer].index_select(0, local)])
        kv = torch.where(own[None, :, None, None], kv, 0)
        for group in self.groups:
            kv = sharding.all_reduce_sum(kv, group)
        return kv[0], kv[1]


@dataclasses.dataclass
class PagedSlots:
    """One paged call's addressing, resolved by the caller through the
    page tables into flat pool positions (the reference's ``PagedSlots``,
    ``kubeflow_tpu/models/layers.py:16-42``):

      write   [b, s] long  pool position of each incoming token
      read    [b, L] long  pool position of each of the row's L logical
                           slots (unallocated pages: the null page)
      slots   [b, s] long  logical slot of each incoming token: a token
                           sees the slots up to its own (plus the caller's
                           pad row); unused when ``prefix_len`` is set
      pool_positions       the pool's leading dimension

    ``prefix_len`` marks a prefill chunk: every row's chunk starts at
    logical slot ``prefix_len``, and the chunk attends causally,
    end-aligned, over the first ``prefix_len + s`` slots of the rows."""

    write: torch.Tensor
    read: torch.Tensor
    slots: Optional[torch.Tensor]
    pool_positions: int
    prefix_len: Optional[int] = None


@dataclasses.dataclass
class PagedView:
    """A paged step's addressing as every layer takes it, flattened once a
    step by ``Llama.forward``: ``write`` [b * s], ``read`` [b * length]
    (index_select over the pool gives the rows' [b, length] view), and
    whether the call is a prefill chunk (``causal``)."""

    write: torch.Tensor
    read: torch.Tensor
    length: int
    causal: bool


def verify_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """The speculative verify pass's attention: k + 1 queries a row at
    per-row offsets over the row's gathered view, with the caller's bias
    [b, 1, s, L].  The reference computes this pass as XLA attention with
    a bias, outside any Pallas kernel (``kubeflow_tpu/models/layers.py``
    ``:228-232``), so no kernel is ported for it: it runs the plain torch
    ops on every device (a kernel for it is queued as speed work).
    ``verify_attention.calls`` counts its calls."""
    verify_attention.calls += 1
    return ops.dot_product_attention(q, k, v, bias=bias, impl="plain")


verify_attention.calls = 0


class Attention(nn.Module):
    """Grouped-query self-attention with RoPE over ``ops``.

    Without a cache: causal attention over the sequence (``segment_ids``
    masks packed documents).  With a ``KVCache`` (scalar-index mode): the
    new K/V are written at ``cache.index``; a multi-token call at index 0
    (prefill) attends causally over the fresh q/k/v only, one at a later
    index (a later prefill chunk) end-aligned causally over the written
    slots, and a single-token call (decode) attends over the whole cache
    with the caller's bias row [b, length] (causal + padding).  With
    ``cache_slots`` [b] (per-row mode, single-token only): row r writes
    its K/V at slot ``cache_slots[r]`` and the caller's bias rows carry
    the whole per-row visibility (the continuous-batching slot pool,
    whose rows sit at different depths).  With a ``PagedKVCache`` and the
    step's ``PagedView`` (paged mode): the new K/V scatter to their pool
    positions and the rows' views are gathered from the pool; a
    single-token call runs K5 over the view with the caller's bias rows, a
    prefill chunk K2 causal and end-aligned (sq < sk), and the
    speculative verify pass ``verify_attention`` with the caller's bias
    [b, 1, s, L].  Pool positions that several rows write at once lie on
    the null page, which every mask hides."""

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
        lin = lambda i, o, block=0: Linear(
            i, o, dtype=dtype, param_dtype=param_dtype, out_block=block,
            device=device)
        # The reference's q/k/v kernels are (dim, heads, head_dim).
        self.q_proj = lin(dim, num_heads * head_dim, head_dim)
        self.k_proj = lin(dim, num_kv_heads * head_dim, head_dim)
        self.v_proj = lin(dim, num_kv_heads * head_dim, head_dim)
        self.o_proj = lin(num_heads * head_dim, dim)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, layer: int = 0,
                bias_rows: Optional[torch.Tensor] = None,
                cache_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        # Under tensor parallelism q/k/v hold this rank's heads (their
        # row shards) and o_proj the matching input columns: the heads are
        # counted from the projections, and o_proj's partial sums are
        # summed over tp.
        tp = sharding.tp_group(sharding.stored(self.q_proj, "weight"),
                               self.num_heads * self.head_dim)
        if tp is not None and (self.num_heads % tp.size()
                               or self.num_kv_heads % tp.size()):
            raise ValueError(
                f"tp={tp.size()} must divide n_heads={self.num_heads} and "
                f"n_kv_heads={self.num_kv_heads}")
        x = sharding.copy_to_tp(x, tp)
        q = self.q_proj(x).view(b, s, -1, self.head_dim)
        k = self.k_proj(x).view(b, s, -1, self.head_dim)
        v = self.v_proj(x).view(b, s, -1, self.head_dim)
        q = apply_rope(q, positions, theta=self.rope_theta)
        k = apply_rope(k, positions, theta=self.rope_theta)
        if isinstance(cache, PagedKVCache):
            out = self._paged(q, k, v, cache, layer, cache_slots, bias_rows)
        elif cache is None:
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
                return sharding.reduce_from_tp(
                    self.o_proj(out.reshape(b, s, -1)), tp)
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
                # A later chunk: end-aligned causal attention over the
                # written slots 0 .. idx + s - 1 is the reference's
                # cached bias (slot j visible to the query at slot idx + i
                # iff j <= idx + i; unwritten slots hidden), as a paged
                # chunk runs it.  The kernel takes contiguous K/V, so a
                # cache longer than the written prefix is copied.
                end = idx + s
                out = ops.dot_product_attention(
                    q, k_buf[:, :end].contiguous(),
                    v_buf[:, :end].contiguous(), causal=True,
                    impl=self.impl)
        return sharding.reduce_from_tp(self.o_proj(out.reshape(b, s, -1)),
                                       tp)

    def _paged(self, q, k, v, cache: PagedKVCache, layer: int,
               view: Optional[PagedView], bias_rows) -> torch.Tensor:
        if not isinstance(view, PagedView):
            raise ValueError("a paged cache needs the step's PagedView "
                             "(Llama.forward builds it from PagedSlots)")
        b, s = q.shape[:2]
        # Under tp the projections hold this rank's K/V heads.
        kvh, d = k.shape[2], self.head_dim
        cache.write(layer, view.write, k.reshape(b * s, kvh, d),
                    v.reshape(b * s, kvh, d))
        # The gather keeps logical order, so a row's view is the layout
        # the contiguous cache would hold; the null page's slots lie
        # behind the mask (bias rows, or the causal bound of a chunk).
        k_rows, v_rows = cache.gather(layer, view.read)
        k_rows = k_rows.view(b, view.length, kvh, d)
        v_rows = v_rows.view(b, view.length, kvh, d)
        if view.causal:
            # A prefill chunk: every row's chunk starts at the same logical
            # slot, so end-aligned causal attention over the first
            # prefix + s slots is the reference's causal + pad bias on
            # every valid query (as in the prefill above: a valid query of
            # a right-padded row never sees a pad or an unwritten slot).
            return ops.dot_product_attention(q, k_rows, v_rows, causal=True,
                                             impl=self.impl)
        if bias_rows is None:
            raise ValueError("a paged decode or verify step needs bias rows")
        if s == 1:
            return ops.decode_attention(q, k_rows, v_rows, bias_rows,
                                        impl=self.impl)
        return verify_attention(q, k_rows, v_rows, bias_rows)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, *, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        lin = lambda i, o: Linear(i, o, dtype=dtype, param_dtype=param_dtype,
                                  device=device)
        self.hidden_dim = hidden_dim
        self.gate_proj = lin(dim, hidden_dim)
        self.up_proj = lin(dim, hidden_dim)
        self.down_proj = lin(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # gate/up column-parallel, down row-parallel under tp (as Attention).
        tp = sharding.tp_group(sharding.stored(self.gate_proj, "weight"),
                               self.hidden_dim)
        x = sharding.copy_to_tp(x, tp)
        return sharding.reduce_from_tp(
            self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)), tp)


# -- Encoder and convolution blocks (ViT, BERT, ResNet) ------------------------


class Mlp(nn.Module):
    """The classic GELU MLP of ViT and BERT (``kubeflow_tpu/models/layers.py``
    ``Mlp``): biased ``fc1``, flax's ``nn.gelu`` (the tanh approximation),
    biased ``fc2``."""

    def __init__(self, dim: int, hidden_dim: int, *, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        lin = lambda i, o: Linear(i, o, dtype=dtype, param_dtype=param_dtype,
                                  bias=True, device=device)
        self.fc1 = lin(dim, hidden_dim)
        self.fc2 = lin(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics over the last axis in f32, epsilon
    1e-6 (torch's default is 1e-5), f32 ``scale`` (ones) and ``bias``
    (zeros), the output in the compute dtype."""

    eps = 1e-6

    def __init__(self, dim: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.empty(dim, dtype=torch.float32, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(
            torch.empty(dim, dtype=torch.float32, device=device),
            requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, self.eps).to(self.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    1 - rate and scale it by 1 / (1 - rate), the draws from ``generator``
    (JAX's random bits cannot be reproduced, only their statistics)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout rate {rate} in training needs a "
                         "torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class EncoderAttention(nn.Module):
    """Bidirectional multi-head self-attention of the encoders: the
    reference's ``Attention`` with ``rope=False``, ``causal=False``, as many
    kv heads as q heads and no cache (``kubeflow_tpu/models/layers.py``
    ``:101-120``).  q/k/v/o are bias-free.  A call with ``mask_bias``
    (BERT's key padding, [b, 1, 1, s]) runs the plain attention: the flash
    kernel takes no additive bias, as the reference names ``"xla"`` for
    its biased calls."""

    def __init__(self, dim: int, num_heads: int, *, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None,
                 softmax_scale: Optional[float] = None, impl: str = "auto",
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.softmax_scale = softmax_scale
        self.impl = impl
        inner = num_heads * self.head_dim
        lin = lambda i, o, block=0: Linear(
            i, o, dtype=dtype, param_dtype=param_dtype, out_block=block,
            device=device)
        self.q_proj = lin(dim, inner, self.head_dim)
        self.k_proj = lin(dim, inner, self.head_dim)
        self.v_proj = lin(dim, inner, self.head_dim)
        self.o_proj = lin(inner, dim)

    def forward(self, x: torch.Tensor, *,
                mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        shape = (b, s, self.num_heads, self.head_dim)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        out = ops.dot_product_attention(
            q, k, v, bias=mask_bias, softmax_scale=self.softmax_scale,
            impl=self.impl if mask_bias is None else "plain")
        return self.o_proj(out.reshape(b, s, -1))


@dataclasses.dataclass
class Seq2SeqCache(KVCache):
    """An encoder-decoder's decode cache: per decoder layer the
    self-attention K/V [b, length, h, d] written at the shared ``index``
    (the decode step), and the cross-attention K/V [b, src_len, h, d],
    projected from the encoder output by the first step and reused by
    every later one (the reference's ``cached_cross_key``/``_value``,
    ``kubeflow_tpu/models/layers.py:145-155``).  A beam search re-gathers
    ``k`` and ``v`` rows after their parents and leaves the cross K/V,
    which are equal across a source's beams."""

    cross_k: List[Optional[torch.Tensor]] = dataclasses.field(
        default_factory=list)
    cross_v: List[Optional[torch.Tensor]] = dataclasses.field(
        default_factory=list)

    @classmethod
    def empty(cls, n_layers: int, batch: int, length: int, heads: int,
              head_dim: int, *, dtype: torch.dtype,
              device) -> "Seq2SeqCache":
        self_kv = KVCache.empty(n_layers, batch, length, heads, head_dim,
                                dtype=dtype, device=device)
        return cls(k=self_kv.k, v=self_kv.v, cross_k=[None] * n_layers,
                   cross_v=[None] * n_layers)


class BiasedAttention(nn.Module):
    """Multi-head attention whose every call carries an additive bias: the
    parts of the reference's ``Attention`` that T5 uses
    (``kubeflow_tpu/models/layers.py:101-233``) — an explicit
    ``head_dim``, a ``softmax_scale`` (T5's 1.0: unscaled; None is
    1/sqrt(head_dim), tested with ``is not None`` so 1.0 is never taken
    for unset), as many kv heads as q heads, no RoPE.

    Modes, by the arguments of ``forward``:
      * self-attention over ``x`` (``causal`` for a decoder);
      * cross-attention over ``kv`` (an encoder output), never causal;
      * with a ``Seq2SeqCache``: self-attention writes its K/V at
        ``cache.index`` and attends over the whole cache, the caller's
        bias hiding the slots past the step; cross-attention projects
        ``kv`` into the cache at the first step and reuses it after.

    The bias ([1 or b, h or 1, sq, sk] f32: T5's per-head relative bias,
    key padding, the cache's visibility) is added to the logits.  The
    flash kernels take no additive bias, and K5's bias rows are
    head-uniform: a per-head bias must not be collapsed into them (the
    reference refuses the same, ``layers.py:212-227``).  So every call
    runs the plain attention, named at the call site, as the reference's
    biased calls run XLA's."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, *,
                 dtype: torch.dtype, param_dtype: Optional[torch.dtype] = None,
                 softmax_scale: Optional[float] = None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.softmax_scale = softmax_scale
        inner = num_heads * head_dim
        lin = lambda i, o, block=0: Linear(
            i, o, dtype=dtype, param_dtype=param_dtype, out_block=block,
            device=device)
        self.q_proj = lin(dim, inner, head_dim)
        self.k_proj = lin(dim, inner, head_dim)
        self.v_proj = lin(dim, inner, head_dim)
        self.o_proj = lin(inner, dim)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.view(t.shape[0], t.shape[1], self.num_heads, self.head_dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, *,
                kv: Optional[torch.Tensor] = None, causal: bool = False,
                cache: Optional[Seq2SeqCache] = None,
                layer: int = 0) -> torch.Tensor:
        b, s, _ = x.shape
        q = self._heads(self.q_proj(x))
        if kv is not None:
            if causal:
                raise ValueError("cross-attention is never causal")
            if cache is None or cache.cross_k[layer] is None:
                k = self._heads(self.k_proj(kv))
                v = self._heads(self.v_proj(kv))
                if cache is not None:
                    cache.cross_k[layer], cache.cross_v[layer] = k, v
            else:
                k, v = cache.cross_k[layer], cache.cross_v[layer]
        elif cache is not None:
            # The caller's bias carries the visibility (slot <= step), so
            # the cache path is not causal by position.
            idx = cache.index
            if idx + s > cache.length:
                raise ValueError(
                    f"cache of {cache.length} slots cannot take {s} tokens "
                    f"at index {idx}")
            k, v = cache.k[layer], cache.v[layer]
            k[:, idx:idx + s] = self._heads(self.k_proj(x))
            v[:, idx:idx + s] = self._heads(self.v_proj(x))
            causal = False
        else:
            k, v = self._heads(self.k_proj(x)), self._heads(self.v_proj(x))
        out = ops.dot_product_attention(
            q, k, v, causal=causal, bias=bias,
            softmax_scale=self.softmax_scale, impl="plain")
        return self.o_proj(out.reshape(b, s, -1))


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial axis, (low, high): the total
    max((ceil(size / stride) - 1) * stride + kernel - size, 0), the odd
    one on the high side.  A 3x3 stride-2 window on 56 pixels pads (0, 1),
    where torch's ``padding=1`` pads (1, 1) and shifts every window."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_memory_format(t: torch.Tensor) -> torch.memory_format:
    """The memory layout of NCHW activations and OIHW weights: channels
    last on the card, where cuDNN runs its NHWC convolutions; contiguous
    on the CPU, where torch's channels-last backward of a strided 1x1
    convolution corrupts the heap (torch 2.13)."""
    return (torch.channels_last if t.device.type == "cuda"
            else torch.contiguous_format)


def _pad_nchw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (hl, hh), (wl, wh) = pads
    return F.pad(x, (wl, wh, hl, hh), value=value)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (window, window), (stride, stride), "SAME")``
    on NCHW: padded with -inf by ``same_pads``, then pooled unpadded."""
    pads = [same_pads(n, window, stride) for n in x.shape[2:]]
    if any(lo or hi for lo, hi in pads):
        x = _pad_nchw(x, pads, float("-inf"))
    return F.max_pool2d(x, window, stride)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` over NCHW activations (``conv_memory_format``):
    weight OIHW f32 (flax keeps HWIO; ``models/convert.py`` transposes),
    ``lecun_normal`` at init, the optional bias zeros, computed in
    ``dtype``.  ``padding`` is "SAME" (asymmetric as XLA pads it,
    ``same_pads``), "VALID", or ((top, bottom), (left, right))."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 *, padding="SAME", bias: bool = False, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, kernel, kernel, dtype=torch.float32,
            device=device), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(
            out_ch, dtype=torch.float32, device=device), requires_grad=False)
            if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _pads(self, x: torch.Tensor):
        if self.padding == "SAME":
            return [same_pads(n, self.kernel, self.stride)
                    for n in x.shape[2:]]
        if self.padding == "VALID":
            return [(0, 0), (0, 0)]
        return [tuple(p) for p in self.padding]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        pads = self._pads(x)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            x = _pad_nchw(x, pads)
            padding = 0
        w = self.weight.to(self.dtype, memory_format=conv_memory_format(x))
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, w, bias, self.stride, padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of NCHW activations, as the
    reference's ResNet builds it (``momentum=0.9``, ``epsilon=1e-5``): f32
    ``scale`` (ones, or zeros with ``zero_scale``) and ``bias``, f32 running
    ``mean`` (zeros) and ``var`` (ones) as buffers.  Training normalises by
    the batch's mean and biased variance and moves the running stats to
    0.9 * running + 0.1 * batch, the variance the biased one: the batch
    statistics come from ``F.batch_norm`` writing into fresh buffers at
    momentum 1, whose variance (the unbiased one) is scaled by (n - 1) / n.
    Eval normalises by the running stats.  The output is in the compute
    dtype."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, channels: int, *, dtype: torch.dtype,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(channels, **f32),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels, **f32),
                                 requires_grad=False)
        self.register_buffer("mean", torch.zeros(channels, **f32))
        self.register_buffer("var", torch.ones(channels, **f32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        x = x.to(self.dtype)
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, self.eps)
        mean = torch.zeros_like(self.mean)
        var = torch.ones_like(self.var)
        y = F.batch_norm(x, mean, var, self.scale, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.var.mul_(m).add_(var, alpha=(1.0 - m) * (n - 1) / n)
        return y
