"""Ring attention: exact attention over a sequence split across the ``sp``
axis (context parallelism).

Counterpart of ``kubeflow_tpu/parallel/ring.py``, in PyTorch's local
view: each process passes its own contiguous chunk of q/k/v, [b, s/sp, h,
d], and gets its chunk of the output, where the reference's
``shard_map`` takes and returns the global arrays.  The K/V chunks travel
round the ring, each process folding every visiting block into a running
(max, denominator, accumulator), the flash merge across processes, so the
[S, S] scores never exist anywhere.

The pieces are plain functions, so a caller can run them without a
process group (``chip_smoke.py`` hands four virtual ranks their blocks):

* ``hop_mode``: how query chunk i sees key block j under causality:
  dense (j < i), diagonal-causal (j == i) or skipped (j > i);
* ``hop``: one (q chunk, k/v block) pair -> ``(out, lse)``, the flash
  forward with its logsumexp (``ops/cuda/flash_attention.py``
  ``flash_attention_with_lse``: K2-lse forward, K3 with the lse cotangent
  and K4 backward on the card), or the plain version in f32 (the
  reference's einsum block); a skipped block launches nothing;
* ``merge`` and ``finish``: the reference's online merge (``:142-150``)
  and the final normalisation, lse [b, h, s] f32, the port's layout (the
  reference lane-replicates it as [b, h, s, 128]).

``ring_attention`` rotates K/V with ``RingShift``, an autograd function
whose forward sends to rank + 1 and receives from rank - 1 and whose
backward sends the gradient the other way, the transpose of
``ppermute`` by which JAX differentiates the reference.  A skipped hop
still takes part in the shift, so every process stays in step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.ops.cuda import flash_attention as fa
from kubeflow_tpu_torch.parallel.mesh import axis_index, axis_size

NEG_INF = -1e30
DENSE, DIAGONAL, SKIPPED = 0, 1, 2
BLOCK_IMPLS = ("auto", "einsum", "flash")


def hop_mode(my_index: int, src_index: int, causal: bool) -> int:
    """DENSE, DIAGONAL or SKIPPED for query chunk ``my_index`` against the
    key block of chunk ``src_index`` (global positions)."""
    if not causal or src_index < my_index:
        return DENSE
    return DIAGONAL if src_index == my_index else SKIPPED


def use_flash(q: torch.Tensor, k: torch.Tensor, block_impl: str) -> bool:
    """Whether blocks run the flash op: always under "flash", for CUDA
    tensors under "auto", never under "einsum".  When they do, a chunk
    shape the kernels do not take raises ``ValueError``: CUDA tensors
    never fall back to the plain blocks."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    flash = block_impl == "flash" or (block_impl == "auto"
                                      and q.device.type == "cuda")
    if flash:
        try:
            if q.shape[-1] not in fa.HEAD_DIMS:
                raise ValueError(f"head_dim {q.shape[-1]} not in "
                                 f"{fa.HEAD_DIMS}")
            if q.device.type == "cuda":
                fa.check_supported(q, k, k, causal=True, segment_ids=None)
        except ValueError as e:
            raise ValueError("flash blocks unsupported for local chunk "
                             f"shape {tuple(q.shape)}: {e}") from None
    return flash


def hop(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
        mode: int, *, softmax_scale: Optional[float] = None,
        flash: bool = True):
    """One block: ``(out f32 [b, s, h, d], lse f32 [b, h, s])`` of q's chunk
    over the block, causal on the diagonal; None for a skipped block
    (nothing runs).  ``flash``: the flash op (the kernels on the card),
    else the plain version in f32."""
    if mode == SKIPPED:
        return None
    causal = mode == DIAGONAL
    if flash:
        out, lse = fa.flash_attention_with_lse(
            q, k_blk, v_blk, causal=causal, softmax_scale=softmax_scale)
    else:
        out, lse = fa.plain_attention_with_lse(
            q.float(), k_blk.float(), v_blk.float(), causal=causal,
            softmax_scale=softmax_scale)
    return out.float(), lse


def init_state(q: torch.Tensor) -> tuple:
    """The running ``(acc [b, s, h, d], m [b, h, s], l [b, h, s])``, f32:
    nothing seen yet."""
    b, s, h, d = q.shape
    return (q.new_zeros((b, s, h, d), dtype=torch.float32),
            q.new_full((b, h, s), NEG_INF, dtype=torch.float32),
            q.new_zeros((b, h, s), dtype=torch.float32))


def merge(state: tuple, out: torch.Tensor, lse: torch.Tensor) -> tuple:
    """Fold one block's normalised output and lse into the running state
    (the block's max is its lse and its denominator 1)."""
    acc, m, l = state
    m_new = torch.maximum(m, lse)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(lse - m_new)
    tr = lambda x: x.transpose(1, 2)[..., None]   # [b, h, s] -> [b, s, h, 1]
    return acc * tr(alpha) + out * tr(beta), m_new, alpha * l + beta


def finish(state: tuple) -> tuple:
    """``(out f32, lse)`` of the whole sequence from the running state."""
    acc, m, l = state
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return acc / safe.transpose(1, 2)[..., None], m + torch.log(safe)


def _sendrecv(tensors, send_to: int, recv_from: int, group) -> tuple:
    ops, outs = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, send_to, group),
                dist.P2POp(dist.irecv, out, recv_from, group)]
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(outs)


class RingShift(torch.autograd.Function):
    """Send tensors to global rank ``send_to`` and receive as many from
    ``recv_from`` over ``group``; the backward sends the gradients back
    the other way."""

    @staticmethod
    def forward(ctx, group, send_to, recv_from, *tensors):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        return _sendrecv(tensors, send_to, recv_from, group)

    @staticmethod
    def backward(ctx, *grads):
        back = _sendrecv(grads, ctx.recv_from, ctx.send_to, ctx.group)
        return (None, None, None) + back


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str = "sp", causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   block_impl: str = "auto") -> torch.Tensor:
    """Exact attention of this process's chunk of the sequence, split in
    rank order over ``axis_name``: q/k/v and the output are the local
    chunks [b, s/sp, h, d] (GQA: k/v with fewer heads).  ``block_impl``:
    "auto" | "einsum" | "flash" (``use_flash``).  Differentiable."""
    flash = use_flash(q, k, block_impl)
    n = axis_size(mesh, axis_name)
    me = axis_index(mesh, axis_name)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    group = mesh.get_group(axis_name)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    state = init_state(q)
    k_blk, v_blk = k, v
    for r in range(n):
        block = hop(q, k_blk, v_blk, hop_mode(me, (me - r) % n, causal),
                    softmax_scale=scale, flash=flash)
        if block is not None:
            state = merge(state, *block)
        else:
            # A skipped block stays in the graph with weight 0, so the
            # backward of the shift that brought it runs on every process
            # (the peers' backward sends wait for it).
            tie = 0.0 * (k_blk.sum() + v_blk.sum())
            state = (state[0] + tie, state[1], state[2])
        if r < n - 1:
            k_blk, v_blk = RingShift.apply(group, nxt, prv, k_blk, v_blk)
    return finish(state)[0].to(q.dtype)
