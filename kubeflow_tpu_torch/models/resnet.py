"""ResNet v1.5 in PyTorch — counterpart of ``kubeflow_tpu/models/resnet.py``.

The stride sits on the 3x3 convolution (v1.5), every block's last norm
starts with a zero scale, and the head is an f32 ``Dense`` over the
global average.  Inputs are NHWC images, as the reference takes them;
the model converts them once at its entry to NCHW with channels-last
memory on the card, where cuDNN runs NHWC convolutions
(``layers.conv_memory_format``).  Convolutions and max-pools
pad as XLA's "SAME" does (asymmetrically, ``layers.same_pads``), and
``BatchNorm`` keeps flax's semantics (``layers.BatchNorm``): the running
stats are buffers, updated in place by a training forward.  Parameters
and stats are f32; the convolutions compute in ``dtype`` (bf16 in every
config but ``resnet_tiny``).  Convolutions, norms and pooling are XLA in
the reference, not Pallas: here they are library calls, and no kernel of
the port runs.  Under a mesh the norms take their statistics over the
data axes' global batch (``layers.BatchNorm``) and the head, the one
parameter ``resnet_rules`` splits over ``tp``, is computed as its shard
(each rank's classes, the logits gathered).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    Linear,
    conv_memory_format,
    head_logits,
    max_pool_same,
)
from kubeflow_tpu_torch.models.registry import register_model

STEMS = ("imagenet", "space_to_depth", "cifar")
BLOCKS = ("basic", "bottleneck")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...]
    block: str = "bottleneck"       # "basic" | "bottleneck"
    num_classes: int = 1000
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16
    stem: str = "imagenet"          # "imagenet" | "space_to_depth" | "cifar"

    def __post_init__(self):
        if self.stem not in STEMS:
            raise ValueError(f"unknown stem {self.stem!r}; expected one of "
                             f"{STEMS}")
        if self.block not in BLOCKS:
            raise ValueError(f"unknown block {self.block!r}; expected one "
                             f"of {BLOCKS}")


CONFIGS = {
    "resnet18": ResNetConfig(stage_sizes=(2, 2, 2, 2), block="basic"),
    "resnet34": ResNetConfig(stage_sizes=(3, 4, 6, 3), block="basic"),
    "resnet50": ResNetConfig(stage_sizes=(3, 4, 6, 3)),
    "resnet101": ResNetConfig(stage_sizes=(3, 4, 23, 3)),
    "resnet152": ResNetConfig(stage_sizes=(3, 8, 36, 3)),
    # The reference's unit-test net: 2 stages, cifar stem, f32.
    "resnet_tiny": ResNetConfig(stage_sizes=(1, 1), block="basic",
                                num_filters=8, num_classes=10, stem="cifar",
                                dtype=torch.float32),
}


class Block(nn.Module):
    """``BasicBlock`` (3x3 -> 3x3) or ``BottleneckBlock`` (1x1 -> 3x3 ->
    1x1, four times the filters out), the stride on the 3x3, a projection
    shortcut (``conv_proj``/``norm_proj``) where the shape changes.  The
    convolutions and norms are numbered as flax numbers them."""

    def __init__(self, in_ch: int, filters: int, stride: int, *,
                 bottleneck: bool, dtype: torch.dtype, device=None):
        super().__init__()
        conv = lambda i, o, k, s=1: Conv2d(i, o, k, s, dtype=dtype,
                                           device=device)
        norm = lambda c, zero=False: BatchNorm(c, dtype=dtype,
                                               zero_scale=zero, device=device)
        if bottleneck:
            out_ch = filters * 4
            self.convs = nn.ModuleList([conv(in_ch, filters, 1),
                                        conv(filters, filters, 3, stride),
                                        conv(filters, out_ch, 1)])
            self.norms = nn.ModuleList([norm(filters), norm(filters),
                                        norm(out_ch, True)])
        else:
            out_ch = filters
            self.convs = nn.ModuleList([conv(in_ch, filters, 3, stride),
                                        conv(filters, filters, 3)])
            self.norms = nn.ModuleList([norm(filters), norm(filters, True)])
        self.out_ch = out_ch
        # The reference projects when the residual's shape differs from
        # the output's: a stride or a change of width (every stage's
        # first block after the first stage has both).
        self.proj = stride != 1 or in_ch != out_ch
        if self.proj:
            self.conv_proj = conv(in_ch, out_ch, 1, stride)
            self.norm_proj = norm(out_ch)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        y = x
        last = len(self.convs) - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y), train=train)
            if i < last:
                y = F.relu(y)
        residual = x
        if self.proj:
            residual = self.norm_proj(self.conv_proj(x), train=train)
        return F.relu(residual + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC [N, H, W, C] -> [N, H/b, W/b, C*b*b], the reference's channel
    order (row offset, column offset, channel)."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth needs H and W divisible by "
                         f"{block}, got {h}x{w}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, c * block * block)


class ResNet(nn.Module):
    """ResNet v1.5.  ``stem="imagenet"``: 7x7/2 conv padded (3, 3), norm,
    relu, 3x3/2 "SAME" max-pool; ``"space_to_depth"``: the input's 2x2
    blocks as 12 channels, a 4x4/1 "SAME" conv, norm, relu, the same
    max-pool (the MLPerf rewrite of the same receptive field); ``"cifar"``:
    a 3x3/1 conv, norm, relu.  Parameters and stats are uninitialised
    after construction: call ``reset_parameters(generator)`` or
    ``load_state_dict``."""

    def __init__(self, cfg: ResNetConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        in_ch = {"imagenet": 3, "space_to_depth": 12, "cifar": 3}[cfg.stem]
        kernel, stride, padding = {
            "imagenet": (7, 2, ((3, 3), (3, 3))),
            "space_to_depth": (4, 1, "SAME"),
            "cifar": (3, 1, "SAME")}[cfg.stem]
        self.conv_init = Conv2d(in_ch, cfg.num_filters, kernel, stride,
                                padding=padding, dtype=cfg.dtype,
                                device=device)
        self.norm_init = BatchNorm(cfg.num_filters, dtype=cfg.dtype,
                                   device=device)
        blocks = []
        ch = cfg.num_filters
        for i, count in enumerate(cfg.stage_sizes):
            for j in range(count):
                block = Block(ch, cfg.num_filters * 2 ** i,
                              2 if i > 0 and j == 0 else 1,
                              bottleneck=cfg.block == "bottleneck",
                              dtype=cfg.dtype, device=device)
                ch = block.out_ch
                blocks.append(block)
        self.blocks = nn.ModuleList(blocks)
        self.head = Linear(ch, cfg.num_classes, dtype=torch.float32,
                           bias=True, device=device)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's flax initialisers (and fresh stats), drawn from
        ``generator`` on the parameters' device."""
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def forward(self, images: torch.Tensor, *,
                train: bool = True) -> torch.Tensor:
        """f32 logits [N, num_classes] from NHWC ``images``; ``train``
        normalises by batch statistics and updates the running ones."""
        cfg = self.cfg
        x = images.to(cfg.dtype)
        if cfg.stem == "space_to_depth":
            x = space_to_depth(x, 2)
        # On the card NHWC memory viewed as NCHW already is channels-last.
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=conv_memory_format(x))
        x = F.relu(self.norm_init(self.conv_init(x), train=train))
        if cfg.stem != "cifar":
            x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x, train=train)
        # jnp.mean over a bf16 array sums in f32 and rounds the mean to bf16.
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(cfg.dtype)
        return head_logits(self.head, x)


def _factory(name):
    @register_model(name)
    def make(*, device=None, **overrides):
        return ResNet(dataclasses.replace(CONFIGS[name], **overrides),
                      device=device)

    make.__name__ = name
    return make


for _name in CONFIGS:
    _factory(_name)
