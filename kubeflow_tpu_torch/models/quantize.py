"""Weight-only int8 for serving — counterpart of
``kubeflow_tpu/models/quantize.py``.

Scheme, the reference's: symmetric absmax / 127 over every axis of the
reference's parameter layout but its LAST one, so one f32 scale per
index of that axis; round half to even, clipped to +-127.  Mapped onto
the port's layouts (``Linear`` weights are [out, in]):

* q/k/v projections (reference (dim, heads, head_dim)): one scale per
  head_dim index, shared by every head;
* the embedding table (reference (vocab, dim)): one scale per column;
* every other matmul weight (o_proj, the SwiGLU projections, ``lm_head``,
  the MoE router): one scale per output row.

What is quantized is selected by the reference's leaf paths: a weight
whose path (``convert.reference_path``, dot-joined) matches
``DEFAULT_PATTERN``, a final segment exactly ``kernel`` or ``embedding``.
So the MoE router (``mlp/router/kernel``) is quantized and the expert
tensors (``mlp/w_gate``, ``w_up``, ``w_down``) and the norm scales are
not, nor T5's relative-bias tables (``*_rel_bias/rel_embedding``, a
suffix match would catch them): they stay f32.

A quantized module keeps only the int8 values and the scales on the
device and dequantizes its one matrix inside ``forward``
(``dequantize``: the int8 values times the scales in bf16, then a cast
to the module's compute dtype), the values the reference's
``dequantize_params`` gives.  The reference's XLA fuses that widening
into each consuming matmul; here it is a separate elementwise pass, so a
quantized decode step moves more bytes than a bf16 one.
"""
from __future__ import annotations

import re
from typing import Callable, Optional

import torch

# Final path segment exactly ``kernel`` or ``embedding`` (the reference's).
DEFAULT_PATTERN = re.compile(r"(^|.*\.)(kernel|embedding)$")


def quantize_tensor(w: torch.Tensor, dims) -> tuple:
    """``(q int8, scale f32)``: absmax / 127 over ``dims`` (kept as size-1
    axes), at least 1e-12; q = round(w / scale) clipped to +-127, all in
    f32 with a true division (the reference's ``quantize_array`` over the
    axes it reduces)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """q x scale in bf16 (one rounding of the exact product), then cast to
    ``dtype``: the reference's ``QTensor.dequantize(bf16)`` followed by
    the module's cast to its compute dtype."""
    return (q * scale.to(torch.bfloat16)).to(dtype)


def quantize_model(model, predicate: Optional[Callable] = None,
                   source: Optional[dict] = None):
    """Quantize ``model``'s selected ``Linear`` and ``Embed`` weights in
    place, one module at a time, each freeing its weight as it goes (an
    8B model never holds two copies).  ``predicate(path, weight) ->
    bool``, ``path`` the reference's dot-joined leaf path, overrides
    ``DEFAULT_PATTERN``.  ``source`` (state-dict key -> tensor, e.g. a
    checkpoint's f32 parameters) gives the values to quantize in place of
    the module's own.  Returns ``model``."""
    from kubeflow_tpu_torch.models.convert import reference_path
    from kubeflow_tpu_torch.models.layers import Embed, Linear

    for name, mod in list(model.named_modules()):
        if isinstance(mod, Linear):
            key, w = f"{name}.weight", mod.weight
        elif isinstance(mod, Embed):
            key, w = f"{name}.embedding", mod.embedding
        else:
            continue
        if w is None:                                   # already int8
            continue
        path = reference_path(key).replace("/", ".")
        if predicate is not None:
            selected = predicate(path, w)
        else:
            selected = w.dim() >= 2 and DEFAULT_PATTERN.match(path)
        if selected:
            with torch.no_grad():
                mod.quantize_(None if source is None else source[key])
    return model


def quantized_bytes(model) -> int:
    """Bytes of the model's weights: int8 values at 1 byte, scales at 4,
    every other tensor at its itemsize (the reference's count)."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())
