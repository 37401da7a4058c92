"""T5-style encoder-decoder in PyTorch — counterpart of
``kubeflow_tpu/models/t5.py``, the seq2seq member of the model zoo.

T5 1.1's shape: RMSNorm pre-norm, a relative-position-bucket attention
bias (no absolute position embeddings) computed once a stack and shared
by its layers, unscaled attention (``softmax_scale=1.0``: the scale is
folded into the initialisation), a gated-GELU feed-forward (flax's
``nn.gelu``, the tanh approximation), one embedding shared by source and
target, and an untied f32 ``lm_head``.  Encoder padding is the additive
bias -1e30 on the keys of both the encoder's self-attention and the
decoder's cross-attention.

Every attention call carries a bias, so it runs the plain attention
(``layers.BiasedAttention``), as the reference's run XLA's; the norms
route through ``cfg.impl``: the RMSNorm kernel on the card, the plain
version on the CPU.  ``encode`` runs the encoder once; ``decode`` runs
the decoder over the whole target (training, scoring) or, with a
``Seq2SeqCache``, one token at the cache's step (generation,
``models/generate.py``).  The parameter names follow the reference's
tree (``models/convert.state_from_flax`` maps one onto the other).

Served under a mesh (``load_service(mesh_spec=)``), T5 stores its
weights split by ``parallel.sharding.t5_rules`` and gathers each whole
at its use (``sharding.GatherAtUse``): every process computes every
head, so its caches keep all heads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.layers import (
    BiasedAttention,
    Embed,
    Linear,
    RMSNorm,
    Seq2SeqCache,
)
from kubeflow_tpu_torch.models.registry import register_model

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 512
    n_encoder_layers: int = 6
    n_decoder_layers: int = 6
    n_heads: int = 8
    head_dim: int = 64
    ffn_dim: int = 1024
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    # Storage dtype of the dense and embedding weights (None: ``dtype``);
    # norm scales, the relative-bias tables and ``lm_head`` are f32.
    param_dtype: Optional[torch.dtype] = None
    # "auto" | "kernel" | "plain": routes RMSNorm (ops/).
    impl: str = "auto"


# The reference's registry names and shapes.
CONFIGS = {
    "t5_debug": T5Config(vocab_size=128, dim=32, n_encoder_layers=2,
                         n_decoder_layers=2, n_heads=2, head_dim=16,
                         ffn_dim=64, dtype=torch.float32),
    "t5_small": T5Config(),
    "t5_base": T5Config(dim=768, n_encoder_layers=12, n_decoder_layers=12,
                        n_heads=12, ffn_dim=2048),
    "t5_large": T5Config(dim=1024, n_encoder_layers=24, n_decoder_layers=24,
                         n_heads=16, ffn_dim=2816),
}


def relative_position_bucket(relative_position: torch.Tensor, *,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's bucket of each relative position (key minus query), long: half
    the buckets exact, half log-spaced out to ``max_distance``.  The log
    is taken in float64, as the reference's numpy does: in float32 the
    product lands on the other side of a bucket edge at some distances
    (``kubeflow_tpu/models/t5.py:110-114``).  Call it on a CPU tensor to
    get the reference's values bit for bit."""
    n = -relative_position.long()
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(n.clamp_min(1).double() / max_exact) / math.log(
        max_distance / max_exact)
    large = max_exact + (log_ratio * (num_buckets - max_exact)).long()
    large = large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, large)


class RelativeBias(nn.Module):
    """A learned [buckets, heads] f32 table -> the [1, heads, q, k] additive
    bias.  A call's buckets come from a table over the relative positions
    it spans, computed on the host (``relative_position_bucket``, bit for
    bit the reference's numpy) and kept on the device, so a decode step
    indexes a table built by the generation's first step without a
    host-to-device copy."""

    # Tables kept at most (one a source length and one a decode length).
    MAX_TABLES = 64

    def __init__(self, cfg: T5Config, *, bidirectional: bool, device=None):
        super().__init__()
        self.bidirectional = bidirectional
        self.num_buckets = cfg.rel_buckets
        self.max_distance = cfg.rel_max_distance
        self.dim = cfg.dim
        self.rel_embedding = nn.Parameter(torch.empty(
            cfg.rel_buckets, cfg.n_heads, dtype=torch.float32,
            device=device), requires_grad=False)
        self._tables: Dict[tuple, torch.Tensor] = {}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``normal(1 / sqrt(dim))``."""
        with torch.no_grad():
            self.rel_embedding.normal_(0.0, 1.0 / math.sqrt(self.dim),
                                       generator=generator)

    def _table(self, q_len: int, k_len: int) -> torch.Tensor:
        """Buckets of the relative positions -(q_len - 1)..k_len - 1, on
        the table's device (entry j is position j - (q_len - 1))."""
        dev = self.rel_embedding.device
        key = (q_len, k_len, dev)
        table = self._tables.get(key)
        if table is None:
            if len(self._tables) >= self.MAX_TABLES:
                self._tables.clear()
            table = relative_position_bucket(
                torch.arange(1 - q_len, k_len),
                bidirectional=self.bidirectional,
                num_buckets=self.num_buckets,
                max_distance=self.max_distance).to(dev)
            self._tables[key] = table
        return table

    def _bias(self, buckets: torch.Tensor) -> torch.Tensor:
        return self.rel_embedding[buckets].permute(2, 0, 1)[None]

    def forward(self, q_len: int, k_len: int) -> torch.Tensor:
        dev = self.rel_embedding.device
        idx = (torch.arange(k_len, device=dev)[None, :]
               - torch.arange(q_len, device=dev)[:, None] + (q_len - 1))
        return self._bias(self._table(q_len, k_len)[idx])

    def at_position(self, pos: int, k_len: int) -> torch.Tensor:
        """The bias row [1, heads, 1, k_len] of one query at ``pos`` (a
        causal decode step): row ``pos`` of ``forward(k_len, k_len)``
        (future keys, which the cache's visibility hides, fall in
        bucket 0)."""
        dev = self.rel_embedding.device
        idx = torch.arange(k_len, device=dev) + (k_len - 1 - pos)
        return self._bias(self._table(k_len, k_len)[idx][None])


class GatedGelu(nn.Module):
    """``wo(gelu(wi_0(x)) * wi_1(x))``, flax's tanh GELU, bias-free."""

    def __init__(self, dim: int, hidden_dim: int, *, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        lin = lambda i, o: Linear(i, o, dtype=dtype, param_dtype=param_dtype,
                                  device=device)
        self.wi_0 = lin(dim, hidden_dim)
        self.wi_1 = lin(dim, hidden_dim)
        self.wo = lin(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh")
                       * self.wi_1(x))


def _attention(cfg: T5Config, device) -> BiasedAttention:
    return BiasedAttention(cfg.dim, cfg.n_heads, cfg.head_dim,
                           dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                           softmax_scale=1.0, device=device)


def _norm(cfg: T5Config, device) -> RMSNorm:
    return RMSNorm(cfg.dim, eps=cfg.norm_eps, impl=cfg.impl, device=device)


def _mlp(cfg: T5Config, device) -> GatedGelu:
    return GatedGelu(cfg.dim, cfg.ffn_dim, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype, device=device)


class T5EncoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        self.attn_norm = _norm(cfg, device)
        self.attn = _attention(cfg, device)
        self.mlp_norm = _norm(cfg, device)
        self.mlp = _mlp(cfg, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), bias)
        return x + self.mlp(self.mlp_norm(x))


class T5DecoderBlock(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        self.self_attn_norm = _norm(cfg, device)
        self.self_attn = _attention(cfg, device)
        self.cross_attn_norm = _norm(cfg, device)
        self.cross_attn = _attention(cfg, device)
        self.mlp_norm = _norm(cfg, device)
        self.mlp = _mlp(cfg, device)

    def forward(self, x, encoded, self_bias, cross_bias, *,
                cache: Optional[Seq2SeqCache] = None,
                layer: int = 0) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_norm(x), self_bias,
                               causal=True, cache=cache, layer=layer)
        x = x + self.cross_attn(self.cross_attn_norm(x), cross_bias,
                                kv=encoded, cache=cache, layer=layer)
        return x + self.mlp(self.mlp_norm(x))


class T5(nn.Module):
    """(source, target) -> [b, target_len, vocab] f32 logits;
    ``source_mask`` [b, src_len] (True on real tokens) hides the source's
    padding from the encoder and from the cross-attention.  Parameters
    are uninitialised after construction: call
    ``reset_parameters(generator)`` or ``load_state_dict``."""

    def __init__(self, cfg: T5Config, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.dim, dtype=cfg.dtype,
                           param_dtype=cfg.param_dtype, device=device)
        self.encoder_rel_bias = RelativeBias(cfg, bidirectional=True,
                                             device=device)
        self.encoder_blocks = nn.ModuleList(
            T5EncoderBlock(cfg, device=device)
            for _ in range(cfg.n_encoder_layers))
        self.encoder_norm = _norm(cfg, device)
        self.decoder_rel_bias = RelativeBias(cfg, bidirectional=False,
                                             device=device)
        self.decoder_blocks = nn.ModuleList(
            T5DecoderBlock(cfg, device=device)
            for _ in range(cfg.n_decoder_layers))
        self.decoder_norm = _norm(cfg, device)
        # The reference computes the head in f32 (dtype=jnp.float32).
        self.lm_head = Linear(cfg.dim, cfg.vocab_size, dtype=torch.float32,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.encoder_norm.scale.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's flax initialisers, drawn from ``generator`` on
        the parameters' device."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def new_cache(self, batch: int, length: int) -> Seq2SeqCache:
        """A decode cache of ``length`` self-attention slots a row (the
        generation's token budget), zeros in the model's dtype."""
        cfg = self.cfg
        return Seq2SeqCache.empty(cfg.n_decoder_layers, batch, length,
                                  cfg.n_heads, cfg.head_dim, dtype=cfg.dtype,
                                  device=self.device)

    @staticmethod
    def pad_bias(source_mask: Optional[torch.Tensor], b: int,
                 src_len: int, device) -> torch.Tensor:
        """The encoder padding's additive bias [b, 1, 1, src_len] f32."""
        if source_mask is None:
            return torch.zeros(b, 1, 1, src_len, device=device)
        return torch.where(source_mask.bool(), 0.0,
                           NEG_INF).float()[:, None, None, :]

    def encode(self, source: torch.Tensor,
               source_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The encoder stack -> [b, src_len, dim]: a bidirectional relative
        bias shared by every layer, plus the padding bias."""
        b, src_len = source.shape
        bias = (self.encoder_rel_bias(src_len, src_len)
                + self.pad_bias(source_mask, b, src_len, source.device))
        x = self.embed(source)
        for block in self.encoder_blocks:
            x = block(x, bias)
        return self.encoder_norm(x)

    def decode(self, encoded: torch.Tensor, target: torch.Tensor, *,
               source_mask: Optional[torch.Tensor] = None,
               cache: Optional[Seq2SeqCache] = None) -> torch.Tensor:
        """The decoder stack over a precomputed ``encoded`` source ->
        logits [b, target_len, vocab] f32.  Without a cache: the whole
        target, causal, with the static relative bias (training,
        scoring).  With a ``Seq2SeqCache``: one token a row at step
        ``cache.index``, which it advances; its bias row, the relative row
        at that step plus the cache's visibility (slot <= step), is built
        here once a step."""
        b, t = target.shape
        cross_bias = self.pad_bias(source_mask, b, encoded.shape[1],
                                   encoded.device)
        if cache is None:
            self_bias = self.decoder_rel_bias(t, t)
        else:
            if t != 1:
                raise ValueError(f"a cached decode step takes one token a "
                                 f"row, got {t}")
            step, length = cache.index, cache.length
            slots = torch.arange(length, device=encoded.device)
            visible = torch.where(slots <= step, 0.0, NEG_INF)
            self_bias = (self.decoder_rel_bias.at_position(step, length)
                         + visible)
        y = self.embed(target)
        for i, block in enumerate(self.decoder_blocks):
            y = block(y, encoded, self_bias, cross_bias, cache=cache, layer=i)
        if cache is not None:
            cache.index += t
        return self.lm_head(self.decoder_norm(y))

    def forward(self, source: torch.Tensor, target: torch.Tensor, *,
                source_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.encode(source, source_mask), target,
                           source_mask=source_mask)


def _factory(name):
    @register_model(name)
    def make(*, device=None, **overrides):
        return T5(dataclasses.replace(CONFIGS[name], **overrides),
                  device=device)

    make.__name__ = name
    return make


for _n in CONFIGS:
    _factory(_n)
