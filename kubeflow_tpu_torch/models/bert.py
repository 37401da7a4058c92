"""BERT encoder in PyTorch — counterpart of ``kubeflow_tpu/models/bert.py``.

Token, position and type embeddings summed and normed, post-norm encoder
blocks, a tanh pooler on the first token and a classifier, both f32.  An
``attention_mask`` [b, s] of {0, 1} becomes the additive key-padding bias
[b, 1, 1, s] (0 or -1e30); such a call runs the plain attention on every
device (the flash kernel takes no bias, as the reference's biased call
is XLA).  Without a mask, attention routes through ``cfg.impl``: the
flash kernels on the card, the plain version on the CPU.  Parameters are
f32; the blocks compute in ``dtype``.  Under a mesh every parameter
``bert_rules`` splits over ``tp`` is computed as its shard
: attention at ``n_heads / tp`` heads (a padded call's
plain route too), the MLP's ``fc1`` column- and ``fc2`` row-parallel,
the token and position tables vocabulary-parallel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from kubeflow_tpu_torch.models.layers import (
    Embed,
    EncoderAttention,
    LayerNorm,
    Linear,
    Mlp,
    dropout,
)
from kubeflow_tpu_torch.models.registry import register_model


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_classes: int = 2        # the sequence-classification head
    dtype: torch.dtype = torch.bfloat16
    dropout: float = 0.0
    # "auto" | "kernel" | "plain": routes unmasked attention (ops/).
    impl: str = "auto"


CONFIGS = {
    "bert_debug": BertConfig(vocab_size=128, dim=32, n_layers=2, n_heads=2,
                             mlp_dim=64, max_seq_len=64, dtype=torch.float32),
    "bert_base": BertConfig(),
    "bert_large": BertConfig(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096),
}


class BertEncoderBlock(nn.Module):
    """Post-norm: norm1(x + attn(x)), then norm2(x + mlp(x)), dropout on
    each branch in training."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        f32 = torch.float32
        self.rate = cfg.dropout
        self.attn = EncoderAttention(cfg.dim, cfg.n_heads, dtype=cfg.dtype,
                                     param_dtype=f32, impl=cfg.impl,
                                     device=device)
        self.norm1 = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.mlp = Mlp(cfg.dim, cfg.mlp_dim, dtype=cfg.dtype,
                       param_dtype=f32, device=device)
        self.norm2 = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)

    def forward(self, x, *, mask_bias, train: bool, generator=None):
        rate = self.rate if train else 0.0
        h = dropout(self.attn(x, mask_bias=mask_bias), rate, generator)
        x = self.norm1(x + h)
        h = dropout(self.mlp(x), rate, generator)
        return self.norm2(x + h)


class Bert(nn.Module):
    """Parameters are uninitialised after construction: call
    ``reset_parameters(generator)`` or ``load_state_dict``."""

    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        f32 = torch.float32
        emb = lambda n: Embed(n, cfg.dim, dtype=cfg.dtype, param_dtype=f32,
                              device=device)
        self.tok_embed = emb(cfg.vocab_size)
        self.pos_embed = emb(cfg.max_seq_len)
        self.type_embed = emb(cfg.type_vocab_size)
        self.embed_norm = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(BertEncoderBlock(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.pooler = Linear(cfg.dim, cfg.dim, dtype=f32, bias=True,
                             device=device)
        self.classifier = Linear(cfg.dim, cfg.num_classes, dtype=f32,
                                 bias=True, device=device)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's flax initialisers, drawn from ``generator``."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor, *,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                train: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f32 logits [b, num_classes] from ``tokens`` [b, s]."""
        b, s = tokens.shape
        if s > self.cfg.max_seq_len:
            raise ValueError(f"sequence of {s} tokens exceeds max_seq_len "
                             f"{self.cfg.max_seq_len}")
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(tokens)
        x = (self.tok_embed(tokens) + self.pos_embed(positions)
             + self.type_embed(token_type_ids))
        x = self.embed_norm(x)
        mask_bias = None
        if attention_mask is not None:
            mask_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e30
        for layer in self.layers:
            x = layer(x, mask_bias=mask_bias, train=train,
                      generator=generator)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)


def _factory(name):
    @register_model(name)
    def make(*, device=None, **overrides):
        return Bert(dataclasses.replace(CONFIGS[name], **overrides),
                    device=device)

    make.__name__ = name
    return make


for _name in CONFIGS:
    _factory(_name)
