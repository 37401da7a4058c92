"""Vision Transformer in PyTorch — counterpart of ``kubeflow_tpu/models/vit.py``.

A VALID 16x16/16 patch convolution with a bias, a zero ``cls_token``, a
learned ``pos_embed`` sized by ``image_size`` (flax infers it from the
first input; here it is fixed at construction), pre-norm encoder blocks,
a final LayerNorm and an f32 head on the CLS row.  Attention routes
through ``cfg.impl``: "auto" takes the flash kernels on the card (K2 for
a forward without autograd, K2-lse with K3 and K4 when training) and the
plain version on the CPU.  Parameters are f32; the blocks compute in
``dtype``.  Under a mesh every parameter ``vit_rules`` splits over
``tp`` is computed as its shard: attention at
``n_heads / tp`` heads, the MLP's ``fc1`` column- and ``fc2``
row-parallel, the head's classes split, their logits gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from kubeflow_tpu_torch.models.layers import (
    Conv2d,
    EncoderAttention,
    LayerNorm,
    Linear,
    Mlp,
    dropout,
    head_logits,
)
from kubeflow_tpu_torch.models.registry import register_model


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    dropout: float = 0.0
    # "auto" | "kernel" | "plain": routes attention (ops/).
    impl: str = "auto"

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} is not a "
                             f"multiple of patch_size {self.patch_size}")
        return (self.image_size // self.patch_size) ** 2


CONFIGS = {
    "vit_debug": ViTConfig(image_size=32, patch_size=8, dim=32, n_layers=2,
                           n_heads=2, mlp_dim=64, num_classes=10,
                           dtype=torch.float32),
    "vit_s16": ViTConfig(dim=384, n_layers=12, n_heads=6, mlp_dim=1536),
    "vit_b16": ViTConfig(),
    "vit_l16": ViTConfig(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096),
}


class EncoderBlock(nn.Module):
    """Pre-norm: x + attn(norm1(x)), then + mlp(norm2(x)), dropout on
    each branch in training."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        f32 = torch.float32
        self.rate = cfg.dropout
        self.norm1 = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.attn = EncoderAttention(cfg.dim, cfg.n_heads, dtype=cfg.dtype,
                                     param_dtype=f32, impl=cfg.impl,
                                     device=device)
        self.norm2 = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.mlp = Mlp(cfg.dim, cfg.mlp_dim, dtype=cfg.dtype,
                       param_dtype=f32, device=device)

    def forward(self, x, *, train: bool, generator=None):
        rate = self.rate if train else 0.0
        x = x + dropout(self.attn(self.norm1(x)), rate, generator)
        return x + dropout(self.mlp(self.norm2(x)), rate, generator)


class ViT(nn.Module):
    """Parameters are uninitialised after construction: call
    ``reset_parameters(generator)`` or ``load_state_dict``."""

    def __init__(self, cfg: ViTConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.patch_embed = Conv2d(3, cfg.dim, cfg.patch_size, cfg.patch_size,
                                  padding="VALID", bias=True,
                                  dtype=cfg.dtype, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim, **f32),
                                      requires_grad=False)
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.num_patches + 1, cfg.dim, **f32),
            requires_grad=False)
        self.blocks = nn.ModuleList(EncoderBlock(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = LayerNorm(cfg.dim, dtype=cfg.dtype, device=device)
        self.head = Linear(cfg.dim, cfg.num_classes, dtype=torch.float32,
                           bias=True, device=device)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's flax initialisers: ``cls_token`` zeros,
        ``pos_embed`` normal(0.02)."""
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def forward(self, images: torch.Tensor, *, train: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f32 logits [b, num_classes] from NHWC ``images``; with dropout
        > 0 a training forward draws from ``generator``."""
        cfg = self.cfg
        b = images.shape[0]
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        x = self.patch_embed(x).flatten(2).transpose(1, 2)   # [b, n, dim]
        cls = self.cls_token.to(cfg.dtype).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for block in self.blocks:
            x = block(x, train=train, generator=generator)
        x = self.final_norm(x)
        return head_logits(self.head, x[:, 0])


def _factory(name):
    @register_model(name)
    def make(*, device=None, **overrides):
        return ViT(dataclasses.replace(CONFIGS[name], **overrides),
                   device=device)

    make.__name__ = name
    return make


for _name in CONFIGS:
    _factory(_name)
