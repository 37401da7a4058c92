"""RMSNorm: the plain PyTorch versions and the wrappers of the CUDA kernels
``ops/csrc/rms_norm.cu`` (replace ``kubeflow_tpu/ops/pallas/rms_norm.py``:
the forward ``_kernel`` and its VJP ``_bwd``).

``rms_norm`` (forward) and ``rms_norm_bwd`` (dx and dscale) launch their
kernels for CUDA tensors and raise on what the kernels do not take; they
take the plain versions (``plain_rms_norm``, ``rms_norm_backward``) only
for CPU tensors.  ``rms_norm.launches`` and ``rms_norm_bwd.launches``
count calls that launched (the backward is two kernels, counted once).
``RMSNormFunction`` makes the forward differentiable with the backward.
"""
from __future__ import annotations

import functools

import torch

from kubeflow_tpu_torch.ops import _build

# The kernels' launch shape (the constexprs of rms_norm.cu, held equal by
# tests/test_torch_build_abi.py): a row spreads over at most
# MAX_WARPS_PER_ROW warps of VECS_PER_LANE 16-byte vectors a lane, which
# bounds d; the backward's grid is capped at BWD_BLOCKS_PER_SM blocks an
# SM, and its f32 workspace has one row of d per block.
MAX_WARPS_PER_ROW = 8
VECS_PER_LANE = 8
BWD_BLOCKS_PER_SM = 2
_DTYPES = (torch.bfloat16, torch.float32)


def max_dim(dtype: torch.dtype) -> int:
    """The widest row the kernels hold in registers: 16384 bf16, 8192 f32."""
    return MAX_WARPS_PER_ROW * 32 * VECS_PER_LANE * (16 // dtype.itemsize)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_blocks(rows: int, device: torch.device) -> int:
    """The backward's grid cap: BWD_BLOCKS_PER_SM blocks on every SM of the
    card, and no more blocks than rows.  Its workspace has this many rows
    (the kernel may use fewer)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return min(rows, BWD_BLOCKS_PER_SM * _sm_count(index))


def plain_rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` with f32 accumulation,
    output in ``x.dtype`` (the reference formula, ``ops/norms.py``)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def _check(name: str, x: torch.Tensor, scale: torch.Tensor,
           *others: torch.Tensor) -> int:
    """Raise on what the kernels do not take; returns d."""
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (scale, *others)):
        raise ValueError(f"{name} kernel: tensors on {x.device}, "
                         f"{[t.device for t in (scale, *others)]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in others):
        raise ValueError(f"{name} kernel takes bf16 or f32 x (and g of the "
                         f"same dtype), got {x.dtype}, "
                         f"{[t.dtype for t in others]}")
    d = x.shape[-1]
    if scale.dtype not in _DTYPES or tuple(scale.shape) != (d,):
        raise ValueError(
            f"{name} kernel takes a bf16 or f32 scale of shape ({d},), got "
            f"{scale.dtype} {tuple(scale.shape)}")
    if d % 8 or d > max_dim(x.dtype) or any(
            tuple(t.shape) != tuple(x.shape) for t in others):
        raise ValueError(
            f"{name} kernel needs a last dim that is a multiple of 8 and at "
            f"most {max_dim(x.dtype)} for {x.dtype}, and g of x's shape, "
            f"got {tuple(x.shape)}, {[tuple(t.shape) for t in others]}")
    if not all(t.is_contiguous() for t in (x, scale, *others)):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (x, scale, *others)):
        raise ValueError(f"{name} kernel needs 16-byte aligned tensors")
    return d


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis.  CUDA: the kernel (x bf16 or f32,
    contiguous, last dim a multiple of 8 up to ``max_dim``; scale bf16 or
    f32 of that length, cast to f32 inside)."""
    if x.device.type == "cpu":
        return plain_rms_norm(x, scale, eps=eps)
    d = _check("rms_norm", x, scale)
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    err = _build.library().kft_rms_norm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        _build.stream_handle(x.device))
    _build.check("kft_rms_norm", err)
    rms_norm.launches += 1
    return y


rms_norm.launches = 0


def rms_norm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      *, eps: float = 1e-6):
    """``(dx, dscale)`` of ``rms_norm`` for the cotangent ``g``: the
    reference's formula in f32, dx = r * g * scale - x * r^3 *
    mean(g * scale * x), dscale = sum over rows of g * x * r, with
    r = rsqrt(mean(x^2) + eps); dx in x's dtype, dscale in scale's."""
    d = x.shape[-1]
    x32, g32, s32 = x.float(), g.float(), scale.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    gs = g32 * s32
    dx = r * gs - x32 * r.pow(3) * (gs * x32).mean(dim=-1, keepdim=True)
    dscale = (g32 * x32 * r).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                 eps: float = 1e-6):
    """``(dx, dscale)`` of ``rms_norm`` for the cotangent ``g``.  CUDA: the
    backward kernel, then its workspace sum (x and g of one dtype and
    shape, as ``rms_norm`` takes x); dx in x's dtype, dscale in scale's."""
    if x.device.type == "cpu":
        return rms_norm_backward(x, scale, g, eps=eps)
    d = _check("rms_norm_bwd", x, scale, g)
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    blocks = bwd_blocks(rows, x.device)
    workspace = torch.empty(blocks, d, dtype=torch.float32, device=x.device)
    err = _build.library().kft_rms_norm_bwd(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), workspace.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        blocks, _build.stream_handle(x.device))
    _build.check("kft_rms_norm_bwd", err)
    rms_norm_bwd.launches += 1
    return dx, dscale


rms_norm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """Differentiable ``rms_norm``: the forward kernel and, for the
    gradient, ``rms_norm_bwd`` (the backward kernel on the card, the plain
    version on the CPU).  Saves x and scale; recomputes r."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, g.contiguous(), eps=ctx.eps)
        return dx, dscale, None
