#!/usr/bin/env python3
"""Drive the PyTorch port (``kubeflow_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. device:  the card's name and power limit (nvidia-smi); fails without
   CUDA.  TF32 is switched off so the plain references run in full f32.
2. build:   compiles every CUDA kernel of the serving path with nvcc for
   sm_90a from ``kubeflow_tpu_torch/ops/csrc`` into ``build/kernels``.
3. kernels: each kernel against its plain PyTorch version at the shapes
   the serving path gives it, timed with CUDA events (median of 25 runs,
   L2 flushed before each), beside its bound and one PyTorch library call
   that computes the same function (a yardstick the port never calls);
   first, the timer's reading of a kernel that does no work.  K5 also at
   the scheduler's pool shape (8 slots of 1024 at mixed depths, one free
   slot fully masked, garbage behind the masks).
   Then the shapes the kernels accept beyond the serving path's.
4. compose: ``llama3_8b`` at full width, 2 layers, on the card: the
   kernel route (impl="auto") against impl="plain" on the logits of a
   ragged batch, after prefill and after one decode step.
5. serve:   ``load_service("llama3_8b")`` (32 layers, random bf16 weights
   from seed 0 on the card) behind the HTTP app, pinned to the lock path
   (``use_scheduler=False``: one request at a time, whose launches it
   counts exactly); /readyz, then three POST /v1/generate: A greedy, B
   sampled, C = A again (token-identical).  The kernels' launch counts
   are set to 0 just before A and read just after it; each must equal
   what the path launches.
6. profile: request A's device time by kernel class (torch.profiler).
6b. schedule: the same model behind the continuous-batching scheduler
   (8 slots of 1024 positions, quantum 8): 12 rows in 6 requests over
   HTTP at once, so rows wait for slots and refill them mid-flight.
   Each request's tokens equal the request sent alone; greedy tokens
   agree with the lock path under a teacher-forced prefill; pipelined and
   synchronous loops give equal tokens; launches are exact for a run
   queued before its loop starts; the counters balance.
7. train-kernels: the training kernels (K1 forward and backward, K2-lse
   forward, K3 dq, K4 dk/dv) against their plain versions in f32 on the
   same bf16 inputs, K1 at llama_1b4's rows ([8192, 2048]), attention at
   llama_1b4's training shape (b1 s8192 h16 d128 causal), the same with
   the packed loader's segment ids, and llama3_8b's GQA shape (b1 s4096
   h32/8), timed beside each one's bound and the library call
   (``F.rms_norm``'s backward, SDPA's forward, or its backward, both
   through ``torch.autograd.grad``).
8. train-edges: the K1 backward at row counts around its grid, widths
   from 64 to 16384, f32 and bf16, zero rows and zero cotangents; the
   attention kernels at ragged, cross-length, head_dim 64, one-key, GQA
   1/2/4/8, segment-with-pad and nonzero-g_lse cases.
9. train-compose: ``llama_1b4`` at full width, 2 layers: one grad step on
   the kernel route, the bf16 plain route and an f32 plain model; the
   kernel route's gradients may be no farther from the f32 model's than
   COMPOSE_RATIO times the plain route's.
10. train-variants: the same model's step with remat "block" and "mlp"
   and with the chunked head and loss, against the base step, and with 2
   accumulated microbatches against the whole batch: exact launches per
   step (remat "block" re-runs each block's K1 and K2-lse), peak memory,
   and loss and gradients within VARIANT_TOL.
11. train:  ``kubeflow_tpu_torch.train.run.main`` trains ``llama_1b4``
   (24 layers, b1 s8192, bf16 grads) for 6 steps with the counts set to
   0 just before and read just after (exact launches per step), then one
   profiled step; then 2 packed steps (b4 s2048, segment ids through all
   three training kernels).
12. checkpoint: ``llama_1b4`` at full width, 2 layers: 4 unbroken steps
   against 2 steps, a stop and a resume for 2 more (restored state
   bit-equal to the saved one, also while training goes on during the
   write); then all 24 layers train 3 steps through ``train.run`` with
   ``--checkpoint-dir``, ``load_service`` restores them in bf16, and a
   request served through the scheduler equals ``generate()`` on the
   restored model.

Every line of standard output is one JSON object; the line before the
last lists every kernel with its launches, error and times, and the last
line is the result, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

SEED = 0
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
TIMING_RUNS = 25
# atol = rtol per kernel: its bf16 output against the plain version in f32
# on the same bf16 inputs.  K1 and K5 stay in f32 up to one rounding of
# the output to bf16 (relative error <= 2^-9), so 1e-2 leaves about 5x
# room; K2 also rounds the probabilities to bf16 before the P V product,
# which doubles its error, so it gets 2e-2.
#
# The training kernels, against the plain versions in f32 on the same
# bf16 inputs.  K2-lse: its O is held to K2's tolerance, and its lse, an
# f32 m + log(l) from the same m and l (the m from bf16 logits that the
# plain version also sees), to atol 1e-3 with no rtol.  K3 (dq) and K4
# (dk, dv): relative L2 <= 2e-2 against autograd through the f32 plain
# attention; the kernels round P and dS to bf16 to feed the tensor cores
# (the reference's f32 products do not) and write bf16 gradients, each a
# relative error of ~2^-9 per element, well inside 2e-2.  A reference
# that is zero (dq and dk when a row sees one key) has no scale of its
# own: the distance is then taken against 1e-3 * sqrt(numel).
#
# The K1 backward: dx, like K1's output, is f32 math rounded once to x's
# dtype, so it gets K1's 1e-2; dscale sums the rows in another order than
# the plain version (f32) and rounds once to scale's dtype (bf16 on the
# training path, a relative error <= 2^-9 an element), so it is held by
# relative L2 <= 4e-3 ("rms_norm_bwd_dscale"), twice that rounding.
KERNEL_TOL = {"rms_norm": 1e-2, "flash_attention_fwd": 2e-2,
              "flash_decode": 1e-2, "flash_attention_fwd_lse": 1e-3,
              "flash_attention_dq": 2e-2, "flash_attention_dkv": 2e-2,
              "rms_norm_bwd": 1e-2, "rms_norm_bwd_dscale": 4e-3}
SERVE_KERNELS = ("rms_norm", "flash_attention_fwd", "flash_decode")
# Composition: the bf16 kernel route's relative L2 distance from the same
# model in f32 may be at most this multiple of the bf16 plain route's.
# Both routes round to bf16 at the same places except inside attention
# (the kernels keep P unnormalised in bf16 at prefill and in f32 at
# decode), so an honest kernel route sits about as far from f32 as the
# plain one; a wrong mask or scale would put it many times farther.
COMPOSE_RATIO = 1.5
# Train-variants: (relative loss difference, relative L2 distance of all
# gradients) from the reference step.  Remat recomputes the checkpointed
# forward with the same kernels on the same inputs, so its loss and
# gradients should repeat the base step's; 1e-6 and 1e-3 catch a
# recompute that saw other inputs (a lost segment id or position moves
# them by order 1) without failing on a reordered f32 sum.  The chunked
# head sums the loss in another order (f32, ~1e-7 a term), and its
# gradients, like those of 2 microbatches accumulated in f32, can round
# to the neighbouring bf16 value (2^-8 relative) where an f32 sum moved:
# 1e-5 on the loss and 1e-2 on the gradients.  The microbatches also run
# GEMMs of half the rows, which cuBLAS may tile differently in bf16, so
# their loss gets 1e-3.
VARIANT_TOL = {"remat_block": (1e-6, 1e-3), "remat_mlp": (1e-6, 1e-3),
               "ce_chunk_1024": (1e-5, 1e-2), "grad_accum_2": (1e-3, 1e-2)}

# Tiles, rings and slices of the attention kernels in ops/csrc (the
# constexprs of the .cu files; tests/test_torch_build_abi.py holds the two
# equal), so the edge cases reach one short of a tile, a whole tile, one
# past it, and one past a full ring: K2 streams 128-key tiles through 2
# stages; K3 holds 128 q rows a block and streams 128-key tiles through 2
# stages; K4 holds 128 keys a block and streams 64-row q tiles through 2
# stages; K5 gives each block of a cluster of at most 8 at least 64 keys,
# streamed in chunks of up to 64 keys through 4 stages.
K2_TILE, K2_STAGES = 128, 2
K3_ROWS, K3_KEYS, K3_STAGES = 128, 128, 2
K4_KEYS, K4_ROWS, K4_STAGES = 128, 64, 2
K5_SLICE, K5_CLUSTER, K5_CHUNK, K5_STAGES = 64, 8, 64, 4

# Serving phase: 4 right-padded rows, max_new_tokens 32.
PROMPT_LENS = (17, 128, 300, 512)
NEW_TOKENS = 32

# Schedule phase: the scheduler's pool (KFT_SERVE_SLOTS, _SLOT_LEN,
# _DECODE_QUANTUM).  llama3_8b's default slot length is its max_seq_len,
# 8192, a pool of 8.6 GB that K5 reads whole each step; 1024 holds the
# longest request here (900 + 64).  The K5 row at the pool shape takes its
# rows' visible lengths from POOL_LENS, plus one free row.
POOL_SLOTS, POOL_SLOT_LEN, POOL_QUANTUM = 8, 1024, 8
POOL_LENS = (1, 17, 300, 512, 544, 1023, 1024)
# name -> (prompt lengths, max_new_tokens, sampling): request A, four
# single rows, one seeded sampled request; 12 rows for 8 slots.
SCHEDULE_REQUESTS = {
    "A": (PROMPT_LENS, NEW_TOKENS, {}),
    "B8": ((33,), 8, {}),
    "B16": ((250,), 16, {}),
    "B48": ((64,), 48, {}),
    "B64": ((900,), 64, {}),
    "T": ((5, 60, 100, 400), 24, {"temperature": 0.8, "top_k": 40,
                                  "seed": 7}),
}
# Agreement with the lock path: every greedy token the pool emitted is
# within this of its row's largest logit under a teacher-forced prefill,
# unless twice the largest logit difference measured between the lock
# path's and the pool's decode (the two widths) is larger.
AGREE_GAP = 0.1

# Training phase: the repo's training configuration at full width and
# depth, as the reference's bench trains it (b1 s8192, bf16 gradients).
TRAIN_MODEL = "llama_1b4"
TRAIN_SEQ = 8192
TRAIN_ARGS = ["--model", TRAIN_MODEL, "--batch", "1", "--seq",
              str(TRAIN_SEQ), "--grad-dtype", "bf16", "--steps", "6",
              "--log-every", "1"]
PACKED_ARGS = ["--model", TRAIN_MODEL, "--batch", "4", "--seq", "2048",
               "--grad-dtype", "bf16", "--steps", "2", "--log-every", "1",
               "--packed"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, flops_peak: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def add_rates(row, flops, floor_ms=None):
    """A timed row's achieved rate and roofline share: ``tflops`` is the
    flops its bound counts (visible pairs for attention) over the kernel's
    time, ``bound_share`` is bound_ms / kernel_ms; with the timer's floor,
    ``net_bound_share`` is bound_ms / (kernel_ms - floor).  (K1's rows
    also carry ``same_bytes_ms``: the timer's reading of one PyTorch
    elementwise op that moves the same bytes, a copy for the forward and
    an add of x and g for the backward, the practical floor of a
    bytes-bound kernel under this timer, whose L2 flush leaves dirty lines
    for the timed call to write back.)"""
    row["tflops"] = flops / (row["kernel_ms"] * 1e-3) / 1e12
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    if floor_ms is not None and row["kernel_ms"] > floor_ms:
        row["net_bound_share"] = row["bound_ms"] / (row["kernel_ms"]
                                                    - floor_ms)
    return row


class Timer:
    """CUDA-event timing of one call's device time: median over runs.
    Before each run a 64 MiB write evicts the inputs from L2 (the serving
    path evicts them between uses: a layer's weights are larger than L2),
    then a ~1 ms device-side sleep lets the host enqueue the call before
    the start event fires, so host overhead stays out of the reading."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        self.floor_ms = None    # its reading of a kernel that does no work

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(TIMING_RUNS):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def check_close(name, got, want, tol):
    """Elementwise |got - want| <= tol + tol * |want|.  Returns the max
    abs error and the largest share of its limit any element uses (the
    check fails above 1)."""
    torch = sys.modules["torch"]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (got - want).abs()
    err = diff.max().item()
    share = (diff / (tol + tol * want.abs())).max().item()
    if share > 1.0:
        raise AssertionError(f"{name}: max abs err {err} beyond "
                             f"atol=rtol={tol} (share {share})")
    return err, share


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi[0] if smi else "",
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def phase_build():
    from kubeflow_tpu_torch.ops import _build

    _build.build(force=True, verbose=True)
    _build.library()
    usage = [ln.strip() for ln in _build.last_build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    emit({"phase": "build", "seconds": round(_build.last_build_seconds, 3),
          "sources": [p.name for p in _build.sources()], "ptxas": usage})


def phase_kernels(torch, dev, timer):
    """Each kernel against its plain version; returns the summary row per
    kernel (the shape the serving path calls it at most often)."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_attention as k2
    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    rows = {}
    # The timer's floor: its reading of a kernel that does no work (a
    # one-element fill).  A row that reads near it is launch latency.
    one = torch.zeros(1, device=dev)
    timer.floor_ms = timer(one.zero_)
    emit({"phase": "timer", "one_element_fill_ms": timer.floor_ms})

    # K1: prefill rows (4 x 512 tokens) and decode rows (4 tokens).
    d = 4096
    scale = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).float()
    for nrows, where in ((4 * 512, "prefill"), (4, "decode")):
        x = rnd(nrows, d)
        got = k1.rms_norm(x, scale, eps=1e-5)
        want = k1.plain_rms_norm(x.float(), scale, eps=1e-5)
        tol = KERNEL_TOL["rms_norm"]
        err, share = check_close("rms_norm", got, want, tol)
        nbytes = nrows * d * 4 + d * 4
        flops = 4 * nrows * d
        bms, by = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
        row = {"kernel": "rms_norm", "shape": [nrows, d], "path": where,
               "max_abs_err": err, "tol": tol, "tol_share": share,
               "kernel_ms": timer(lambda: k1.rms_norm(x, scale, eps=1e-5)),
               "plain_ms": timer(lambda: k1.plain_rms_norm(x, scale,
                                                           eps=1e-5)),
               "library_ms": timer(lambda: F.rms_norm(
                   x, (d,), weight=scale.to(bf), eps=1e-5)),
               "same_bytes_ms": timer(lambda: got.copy_(x)),
               "bound_ms": bms, "bound_by": by}
        emit(add_rates(row, flops, timer.floor_ms))
        if where == "decode":
            rows["rms_norm"] = row

    # K2: causal prefill, b=4, h=32 over kv_h=8, d=128; 300 is ragged.
    b, h, kvh, hd = 4, 32, 8, 128
    cases = [(512, False), (300, False), (512, True)]
    for s, packed in cases:
        q, k, v = rnd(b, s, h, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
        seg = None
        if packed:
            # Three documents per row, boundaries differing per row.
            pos = torch.arange(s, device=dev)[None]
            cut = torch.tensor([[100, 250], [37, 400], [256, 300],
                                [1, 511]], device=dev)
            seg = 1 + (pos >= cut[:, :1]).int() + (pos >= cut[:, 1:]).int()
        got = k2.flash_attention(q, k, v, causal=True, segment_ids=seg)
        want = k2.plain_attention(q.float(), k.float(), v.float(),
                                  causal=True, segment_ids=seg)
        tol = KERNEL_TOL["flash_attention_fwd"]
        err, share = check_close("flash_attention_fwd", got, want, tol)
        vis = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
        if seg is not None:
            vis = vis[None] & (seg[:, :, None] == seg[:, None, :])
            pairs = vis.sum().item() * h
        else:
            pairs = vis.sum().item() * h * b
        nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
        flops = 4 * pairs * hd
        bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if seg is None:
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=vis[:, None], enable_gqa=True)
        row = {"kernel": "flash_attention_fwd", "shape": [b, s, h, kvh, hd],
               "segments": packed, "path": "prefill", "max_abs_err": err,
               "tol": tol, "tol_share": share,
               "kernel_ms": timer(lambda: k2.flash_attention(
                   q, k, v, causal=True, segment_ids=seg)),
               "plain_ms": timer(lambda: k2.plain_attention(
                   q, k, v, causal=True, segment_ids=seg)),
               "library_ms": timer(lib), "bound_ms": bms, "bound_by": by}
        emit(add_rates(row, flops))
        if s == 512 and not packed:
            rows["flash_attention_fwd"] = row

    # K5: one decode token over S = prompt + 32 slots, padded rows masked;
    # and one long row (b1 S8192), whose cache is 33.5 MB.
    for b, S in ((4, 512 + NEW_TOKENS), (4, 1000), (1, 8192)):
        q = rnd(b, 1, h, hd)
        k, v = rnd(b, S, kvh, hd), rnd(b, S, kvh, hd)
        lens = [[17], [128], [300], [S]] if b == 4 else [[S]]
        valid = torch.arange(S, device=dev)[None] < torch.tensor(
            lens, device=dev)
        bias = torch.where(valid, 0.0, -1e30).float().contiguous()
        got = k5.flash_decode(q, k, v, bias)
        want = k5.plain_decode(q.float(), k.float(), v.float(), bias)
        tol = KERNEL_TOL["flash_decode"]
        err, share = check_close("flash_decode", got, want, tol)
        nbytes = 2 * b * S * kvh * hd * 2 + b * S * 4 + 2 * b * h * hd * 2
        flops = 4 * b * h * S * hd
        bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = bias[:, None, None, :].to(bf)
        row = {"kernel": "flash_decode", "shape": [b, S, h, kvh, hd],
               "path": "decode", "max_abs_err": err, "tol": tol,
               "tol_share": share,
               "kernel_ms": timer(lambda: k5.flash_decode(q, k, v, bias)),
               "plain_ms": timer(lambda: k5.plain_decode(q, k, v, bias)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=mask, enable_gqa=True)),
               "bound_ms": bms, "bound_by": by}
        emit(add_rates(row, flops))
        if S == 512 + NEW_TOKENS:
            rows["flash_decode"] = row
    emit(add_rates(*pool_decode_row(torch, dev, gen, timer)))
    return rows


def pool_decode_row(torch, dev, gen, timer):
    """K5 at the scheduler's pool shape: q [8, 1, 32, 128] over a cache
    [8, 1024, 8, 128] whose rows see POOL_LENS slots (causal bias, as a
    pool step builds it) and one free row fully masked as the pool masks
    it (pad -1e30 on every slot, written at slot 0).  Behind every mask
    lies finite garbage 50x the live values.  The bound counts the slots
    this data needs: each row's slots at its largest bias."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5

    bf = torch.bfloat16
    b, S, h, kvh, hd = POOL_SLOTS, POOL_SLOT_LEN, 32, 8, 128
    lens = torch.tensor(POOL_LENS + (1,), device=dev)
    live = torch.arange(S, device=dev)[None] < lens[:, None]
    live[-1] = False
    scale = torch.where(live, 1.0, 50.0)[:, :, None, None]
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(bf)
    k = (torch.randn(b, S, kvh, hd, generator=gen, device=dev)
         * scale).to(bf)
    v = (torch.randn(b, S, kvh, hd, generator=gen, device=dev)
         * scale).to(bf)
    causal = torch.where(torch.arange(S, device=dev)[None] < lens[:, None],
                         0.0, -1e30)
    pad = torch.zeros(b, S, device=dev)
    pad[-1] = -1e30
    bias = (causal + pad).float().contiguous()
    got = k5.flash_decode(q, k, v, bias)
    want = k5.plain_decode(q.float(), k.float(), v.float(), bias)
    tol = KERNEL_TOL["flash_decode"]
    err, share = check_close("flash_decode pool", got, want, tol)
    needed = (bias == bias.amax(dim=1, keepdim=True)).sum().item()
    nbytes = 2 * needed * kvh * hd * 2 + b * S * 4 + 2 * b * h * hd * 2
    flops = 4 * h * hd * needed
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = bias[:, None, None, :].to(bf)
    row = {"kernel": "flash_decode", "shape": [b, S, h, kvh, hd],
           "path": "schedule pool", "visible_lens": list(POOL_LENS),
           "free_rows": 1, "needed_slots": needed, "max_abs_err": err,
           "tol": tol, "tol_share": share,
           "kernel_ms": timer(lambda: k5.flash_decode(q, k, v, bias)),
           "plain_ms": timer(lambda: k5.plain_decode(q, k, v, bias)),
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, enable_gqa=True)),
           "bound_ms": bms, "bound_by": by}
    return row, flops


def edge_segments(torch, dev, gen, kind, b, s):
    """Segment ids [b, s] int32 for an edge case, or None.  "blocks": runs
    of 50 (at s300 without the causal mask, tiles whose id ranges do not
    meet are skipped by K2 and K4); "pads": row 0 two documents and a pad tail, row 1 pad rows
    first (segment 0 attends only to segment 0), then two documents;
    "random": ids drawn from {1, 2, 3} per position (not monotone, no
    runs); "permuted": runs of 50 at positions permuted at random;
    "lone": runs of 50 whose row 0 is a one-token segment, so row 0 sees
    no key in any kv tile past the first."""
    if kind is None:
        return None
    pos = torch.arange(s, device=dev)
    if kind == "pads":
        seg = torch.stack([
            torch.where(pos < 50, 1, torch.where(pos < s - 20, 2, 0)),
            torch.where(pos < 10, 0, torch.where(pos < 70, 1, 2))])[:b]
    elif kind == "random":
        seg = torch.randint(1, 4, (b, s), generator=gen, device=dev)
    else:
        seg = (pos // 50 + 1).expand(b, s).clone()
        if kind == "permuted":
            seg = torch.stack([row[torch.randperm(s, generator=gen,
                                                  device=dev)]
                               for row in seg])
        elif kind == "lone":
            seg[:, 0] = -7
    return seg.int().contiguous()


def decode_bias(torch, dev, kind, b, S):
    """A K5 bias [b, S] f32 of -1e30 (the reference's pad value) and 0:
    "thirds" masks every third slot; "block" also masks the whole slice
    of the second block of a cluster of min(K5_CLUSTER, S // K5_SLICE)
    blocks (the first when there is one; where the card holds fewer such
    clusters at once than the grid has, the kernel takes smaller clusters
    and the run spans two slices); "all" masks every slot of row 0 (it
    averages V uniformly)."""
    pos = torch.arange(S, device=dev)
    masked = (pos % 3 == 1)[None].expand(b, S).clone()
    if kind == "block":
        n = max(1, min(K5_CLUSTER, S // K5_SLICE))
        per = -(-S // n)
        r = 1 if n > 1 else 0
        masked |= ((pos >= r * per) & (pos < (r + 1) * per))[None]
    elif kind == "all":
        masked[0] = True
    return torch.where(masked, -1e30, 0.0).float().contiguous()


def phase_edges(torch, dev):
    """The shapes the kernels accept beyond the serving path's, each
    against its plain version (untimed): f32 and narrow/wide rows for K1;
    head_dim 64, no mask, cross-length causal, one query or one key,
    key counts around K2's tile and ring, sq 8191, GQA 8 at head_dim 64,
    and segment ids in runs, drawn at random, permuted, or with a
    one-token segment for K2; for K5 every GQA group size, head_dim 64,
    S = 1, lengths around its slice, cluster, chunk and ring, b1 S8192,
    and bias rows that mask every third slot, one whole block's slice
    (``decode_bias``), or every slot of a row."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as k2
    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(
        *s, generator=gen, device=dev).to(dt)
    # Per kernel: cases run, and the case that used most of its limit.
    worst = {name: {"cases": 0, "tol": KERNEL_TOL[name], "tol_share": 0.0}
             for name in SERVE_KERNELS}

    def check(kernel, case, got, want):
        err, share = check_close(f"{kernel} {case}", got, want,
                                 KERNEL_TOL[kernel])
        w = worst[kernel]
        w["cases"] += 1
        if share >= w["tol_share"]:
            w.update(tol_share=share, max_abs_err=err, case=case)

    # (rows, d, x dtype, scale dtype): widths from 8 to the widest a row
    # held in registers takes (16384 bf16, 8192 f32), row counts that
    # leave the grid's last pass ragged, both scale dtypes.
    f32, bf = torch.float32, torch.bfloat16
    for rows, d, dt, st in ((5, 8, f32, f32), (3, 4104, bf, f32),
                            (7, 4096, f32, f32), (2, 64, bf, bf),
                            (1000, 2048, bf, bf), (8193, 2048, bf, f32),
                            (300, 4096, bf, bf), (9, 16384, bf, f32),
                            (5, 8192, f32, bf)):
        x, scale = rnd(rows, d, dt=dt), rnd(d, dt=st)
        check("rms_norm", f"{rows}x{d} {str(dt)[6:]} scale {str(st)[6:]}",
              k1.rms_norm(x, scale), k1.plain_rms_norm(x.float(), scale))
    # (b, sq, sk, h, kv_h, d, causal, segments)
    tile_edges = (K2_TILE - 1, K2_TILE, K2_TILE + 1,
                  K2_STAGES * K2_TILE + 1)
    for b, sq, sk, h, kvh, d, causal, segs in (
            (2, 100, 100, 4, 4, 64, True, None),
            (1, 77, 77, 8, 2, 128, False, None),
            (2, 37, 200, 4, 1, 128, True, None),
            (1, 1, 1, 2, 1, 128, True, None),
            (2, 1, 130, 4, 2, 64, True, None),
            (1, 130, 130, 4, 2, 128, True, "blocks"),
            (1, 64, 1, 4, 2, 128, False, None),
            *((1, n, n, 4, 2, 128, True, None) for n in tile_edges),
            *((1, 50, n, 4, 2, 64, False, None) for n in tile_edges),
            (1, 8191, 8191, 2, 1, 128, True, None),
            (1, 129, 300, 4, 2, 128, True, None),
            (2, 200, 200, 8, 1, 64, True, None),
            (2, 300, 300, 4, 2, 128, False, "blocks"),
            (2, 300, 300, 4, 2, 128, True, "random"),
            (1, 257, 257, 4, 4, 64, False, "random"),
            (2, 300, 300, 4, 2, 128, True, "permuted"),
            (1, 300, 300, 4, 2, 128, False, "lone")):
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d)
        seg = edge_segments(torch, dev, gen, segs, b, sq)
        check("flash_attention_fwd",
              f"b{b} sq{sq} sk{sk} h{h}/{kvh} d{d} causal={causal} "
              f"segments={segs}",
              k2.flash_attention(q, k, v, causal=causal, segment_ids=seg),
              k2.plain_attention(q.float(), k.float(), v.float(),
                                 causal=causal, segment_ids=seg))
    # (b, S, h, kv_h, d, bias)
    lengths = sorted({1, K5_SLICE - 1, K5_SLICE, K5_SLICE + 1,
                      K5_CHUNK - 1, K5_CHUNK, K5_CHUNK + 1,
                      K5_CLUSTER * K5_SLICE - 1, K5_CLUSTER * K5_SLICE,
                      K5_CLUSTER * K5_SLICE + 1,
                      K5_CLUSTER * (K5_STAGES * K5_CHUNK + 1)})
    cases = [(3, 1, 8, 8, 128, "thirds"), (2, 63, 4, 2, 64, "thirds"),
             (2, 65, 8, 2, 128, "thirds"), (1, 300, 8, 1, 64, "thirds"),
             (2, 129, 16, 2, 128, "thirds")]
    cases += [(2, n, 8, 2, 128, "thirds") for n in lengths]
    cases += [(1, n, 16, 2, 64, "block") for n in lengths if n > 1]
    cases += [(1, 8192, 32, 8, 128, "thirds"), (2, 8192, 8, 8, 64, "block"),
              (2, 544, 32, 8, 128, "all"), (2, 100, 4, 4, 64, "all"),
              (2, 2000, 16, 4, 128, "block")]
    for b, S, h, kvh, d, kind in cases:
        q, k, v = rnd(b, 1, h, d), rnd(b, S, kvh, d), rnd(b, S, kvh, d)
        bias = decode_bias(torch, dev, kind, b, S)
        check("flash_decode", f"b{b} S{S} h{h}/{kvh} d{d} bias={kind}",
              k5.flash_decode(q, k, v, bias),
              k5.plain_decode(q.float(), k.float(), v.float(), bias))
    emit({"phase": "edges", "worst_by_kernel": worst})


def ragged_batch(torch, dev, vocab, lens):
    import numpy as np

    rs = np.random.RandomState(SEED)
    longest = max(lens)
    toks = [rs.randint(0, vocab, size=n).tolist() for n in lens]
    prompt = torch.tensor([t + [0] * (longest - len(t)) for t in toks],
                          device=dev)
    mask = torch.arange(longest, device=dev)[None] < torch.tensor(
        lens, device=dev)[:, None]
    return toks, prompt, mask


def phase_compose(torch, dev):
    """Full-width llama3_8b, 2 layers, the same weights three ways: bf16
    through the kernels (impl="auto"), bf16 plain (impl="plain"), and an
    f32 copy on the plain route as the reference.  Compared on the prefill
    logits at each row's last prompt token and on one decode step's
    logits: the kernel route must be no farther from the f32 model than
    COMPOSE_RATIO times the plain route."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.generate import pad_bias_rows, prompt_positions

    variants = {"auto": dict(impl="auto"), "plain": dict(impl="plain"),
                "f32": dict(impl="plain", dtype=torch.float32)}
    models = {name: create_model("llama3_8b", device=dev, n_layers=2, **kw)
              for name, kw in variants.items()}
    with torch.no_grad():
        models["auto"].reset_parameters(
            torch.Generator(device=dev).manual_seed(SEED))
    for name in ("plain", "f32"):
        models[name].load_state_dict(models["auto"].state_dict())
    _, prompt, mask = ragged_batch(torch, dev, 128256, PROMPT_LENS)
    positions, lengths = prompt_positions(mask)
    pad_bias = pad_bias_rows(mask, prompt.shape[1] + 1)
    nxt = torch.arange(len(PROMPT_LENS), device=dev)[:, None] + 7
    out = {}
    for name, model in models.items():
        with torch.inference_mode():
            cache = model.new_cache(len(PROMPT_LENS), prompt.shape[1] + 1)
            pre = model(prompt, positions=positions, cache=cache,
                        pad_bias=pad_bias, logits_at=lengths - 1)
            dec = model(nxt, positions=lengths[:, None], cache=cache,
                        pad_bias=pad_bias)[:, 0]
        out[name] = pre.float(), dec.float()
        del cache
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    row = {"phase": "compose", "model": "llama3_8b", "n_layers": 2,
           "prompt_lens": list(PROMPT_LENS), "ratio_limit": COMPOSE_RATIO}
    for i, step in enumerate(("prefill", "decode")):
        ref = out["f32"][i]
        for name in ("auto", "plain"):
            if not torch.isfinite(out[name][i]).all():
                raise AssertionError(f"compose {step} {name}: non-finite")
        e_auto, e_plain = rel(out["auto"][i], ref), rel(out["plain"][i], ref)
        row[f"{step}_rel_l2_kernel_vs_f32"] = e_auto
        row[f"{step}_rel_l2_plain_vs_f32"] = e_plain
        row[f"{step}_rel_l2_kernel_vs_plain"] = rel(out["auto"][i],
                                                    out["plain"][i])
        row[f"{step}_max_abs_err_kernel_vs_f32"] = (
            out["auto"][i] - ref).abs().max().item()
        if e_auto > COMPOSE_RATIO * e_plain:
            raise AssertionError(
                f"compose {step}: kernel route {e_auto} from the f32 model, "
                f"more than {COMPOSE_RATIO} x the plain route's {e_plain}")
    row["greedy_agreement_kernel_vs_f32"] = (
        out["auto"][0].argmax(-1) == out["f32"][0].argmax(-1)
    ).float().mean().item()
    emit(row)
    del models, out
    torch.cuda.empty_cache()


def http(base, path, body=None, timeout=600):
    """One request to the local server (no proxy, whatever the env says)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        "Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=timeout) as resp:
        raw = resp.read()
        return resp.status, (json.loads(raw) if path != "/metrics"
                             else raw.decode())


def phase_serve(torch, dev):
    from kubeflow_tpu_torch.models.serve import create_app, load_service
    from kubeflow_tpu_torch.ops import cuda as kernels

    t0 = time.perf_counter()
    # The lock path, whose one request at a time the counts below hold;
    # phase_schedule serves the same model through the scheduler.
    service = load_service("llama3_8b", device="cuda", seed=SEED,
                           use_scheduler=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = service.model.cfg
    server = create_app(service, model_name="llama3_8b").make_server(
        "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, ready = http(base, "/readyz")
        if status != 200 or not ready.get("ready"):
            raise AssertionError(f"/readyz: {status} {ready}")
        toks, _, _ = ragged_batch(torch, dev, cfg.vocab_size, PROMPT_LENS)
        body_a = {"tokens": toks, "max_new_tokens": NEW_TOKENS,
                  "temperature": 0.0}
        body_b = dict(body_a, temperature=0.8, top_k=40, seed=1)
        torch.cuda.reset_peak_memory_stats()

        kernels.reset_launch_counts()
        t_a = time.perf_counter()
        _, out_a = http(base, "/v1/generate", body_a)
        t_a = time.perf_counter() - t_a
        counts = kernels.launch_counts()

        forwards = NEW_TOKENS            # 1 prefill + 31 decode steps
        want = {"rms_norm": (2 * cfg.n_layers + 1) * forwards,
                "rms_norm_bwd": 0, "flash_attention_fwd": cfg.n_layers,
                "flash_attention_fwd_lse": 0, "flash_attention_dq": 0,
                "flash_attention_dkv": 0,
                "flash_decode": cfg.n_layers * (NEW_TOKENS - 1)}
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        _, traces = http(base, "/debug/traces?n=1")
        spans = {s["name"]: s for s in traces["traces"][-1]["spans"]}
        pre = spans["prefill"]
        ttft_s = (pre["offset_ms"] + pre["duration_ms"]) / 1e3
        decode_s = spans["decode"]["duration_ms"] / 1e3

        _, out_b = http(base, "/v1/generate", body_b)
        _, out_c = http(base, "/v1/generate", body_a)
        for name, out in (("A", out_a), ("B", out_b), ("C", out_c)):
            rows = out["tokens"]
            if len(rows) != len(PROMPT_LENS) or any(
                    len(r) != NEW_TOKENS or not all(
                        0 <= t < cfg.vocab_size for t in r) for r in rows):
                raise AssertionError(f"request {name}: malformed {rows}")
        if out_c["tokens"] != out_a["tokens"]:
            raise AssertionError("request C differs from A")
        _, metrics = http(base, "/metrics")
        if "serve_output_tokens_total" not in metrics:
            raise AssertionError("/metrics lacks the token counter")
        if service._scheduler is not None:
            raise AssertionError("the pinned lock path started a scheduler")
        emit({"phase": "serve", "model": "llama3_8b", "engine": "lock",
              "load_seconds": load_s, "prompt_lens": list(PROMPT_LENS),
              "max_new_tokens": NEW_TOKENS, "request_a_seconds": t_a,
              "ttft_seconds": ttft_s,
              "decode_tokens_per_s": len(PROMPT_LENS) * (NEW_TOKENS - 1)
              / decode_s,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": counts, "a_equals_c": True,
              "a_row0_head": out_a["tokens"][0][:8],
              "b_row0_head": out_b["tokens"][0][:8]})
        return counts, service.model
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def phase_profile(torch, dev, model):
    """Where request A's time goes: the same generate call, direct (no
    HTTP), once on the host clock and once under torch.profiler; device
    time per kernel class from the profiler's CUDA kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import generate, row_generators

    _, prompt, mask = ragged_batch(torch, dev, model.cfg.vocab_size,
                                   PROMPT_LENS)
    run = lambda: generate(model, prompt, prompt_mask=mask,
                           max_new_tokens=NEW_TOKENS,
                           generators=row_generators(SEED, 4, dev))
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    classes = {"rms_norm": 0.0, "flash_attention_fwd": 0.0,
               "flash_decode": 0.0, "matmul": 0.0, "other": 0.0}
    by_name = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        us = e.time_range.elapsed_us()
        name = e.name
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
        if "rms_norm_kernel" in name:
            classes["rms_norm"] += us
        elif "flash_fwd_kernel" in name:
            classes["flash_attention_fwd"] += us
        elif "flash_decode_kernel" in name:
            classes["flash_decode"] += us
        elif any(t in name.lower() for t in ("gemm", "gemv", "cutlass",
                                             "xmma", "cublas", "nvjet")):
            classes["matmul"] += us
        else:
            classes["other"] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    device_s = sum(classes.values()) / 1e6
    emit({"phase": "profile", "call": "generate (request A, no HTTP)",
          "wall_seconds": wall_s, "device_kernel_seconds": device_s,
          "device_busy_share": device_s / wall_s if device_s else None,
          "device_kernels": n_kernels,
          "device_ms_by_class": {k: v / 1e3 for k, v in classes.items()},
          "top_kernels": [{"name": name[:90], "ms": t / 1e3, "count": c}
                          for name, (t, c) in top]})


def schedule_bodies(torch, dev, vocab):
    """The schedule phase's requests: name -> POST /v1/generate body.
    Request A is the serve phase's; the others draw from seed SEED + 10."""
    import numpy as np

    rs = np.random.RandomState(SEED + 10)
    bodies = {}
    for name, (lens, n, kw) in SCHEDULE_REQUESTS.items():
        if name == "A":
            rows = ragged_batch(torch, dev, vocab, lens)[0]
        else:
            rows = [rs.randint(0, vocab, size=m).tolist() for m in lens]
        bodies[name] = {"tokens": rows, "max_new_tokens": n,
                        "temperature": 0.0, **kw}
    return bodies


def schedule_launches(cfg, prefills, steps):
    """Launches of the scheduler's path: each admission prefill and each
    pool step is one forward (two norms a layer and the final one); a
    prefill runs K2 once a layer, a pool step K5 once a layer."""
    n = cfg.n_layers
    return {"rms_norm": (2 * n + 1) * (prefills + steps), "rms_norm_bwd": 0,
            "flash_attention_fwd": n * prefills,
            "flash_attention_fwd_lse": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0, "flash_decode": n * steps}


def wait_drained(sched, timeout=60.0):
    """Until the scheduler holds no row and no unharvested quantum."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        st = sched.stats()
        if (sched._inflight is None and st["active_rows"] == 0
                and st["queued_rows"] == 0):
            return st
        time.sleep(0.01)
    raise AssertionError(f"scheduler did not drain: {sched.stats()}")


def width_logit_diff(torch, dev, model, rows, gen):
    """The largest |logit| difference between the lock path's decode (the
    request's width, a cache of prompt + budget) and the pool's (width
    POOL_SLOTS, POOL_SLOT_LEN positions, the other slots free), both fed
    the same tokens ``gen`` [b][n] from the same prefill."""
    from kubeflow_tpu_torch.models.generate import NEG_INF, generate_prefill

    b, n = len(rows), len(gen[0])
    longest = max(len(r) for r in rows)
    prompt = torch.tensor([r + [0] * (longest - len(r)) for r in rows],
                          device=dev)
    mask = torch.arange(longest, device=dev)[None] < torch.tensor(
        [len(r) for r in rows], device=dev)[:, None]
    toks = torch.tensor(gen, device=dev)
    worst = 0.0
    with torch.inference_mode():
        _, st = generate_prefill(model, prompt, prompt_mask=mask,
                                 max_new_tokens=n)
        pool = model.new_cache(POOL_SLOTS, POOL_SLOT_LEN)
        length = st.cache.length
        for layer in range(len(pool.k)):
            pool.k[layer][:b, :length] = st.cache.k[layer]
            pool.v[layer][:b, :length] = st.cache.v[layer]
        pads = torch.full((POOL_SLOTS, POOL_SLOT_LEN), NEG_INF, device=dev)
        pads[:b] = 0.0
        pads[:b, :length] = st.pad_bias
        write = torch.zeros(POOL_SLOTS, dtype=torch.long, device=dev)
        write[:b] = longest
        pos = torch.zeros(POOL_SLOTS, dtype=torch.long, device=dev)
        pos[:b] = st.pos
        tok = torch.zeros(POOL_SLOTS, dtype=torch.long, device=dev)
        for t in range(n - 1):
            lock = model(toks[:, t:t + 1], positions=st.pos[:, None],
                         cache=st.cache, pad_bias=st.pad_bias)[:, 0]
            tok[:b] = toks[:, t]
            pooled = model(tok[:, None], positions=pos[:, None], cache=pool,
                           pad_bias=pads,
                           cache_slots=write.clamp_max(POOL_SLOT_LEN - 1))
            worst = max(worst, (lock - pooled[:b, 0]).abs().max().item())
            st.pos += 1
            pos += 1
            write += 1
    return worst


def teacher_forced_gaps(torch, dev, model, row, gen):
    """Each emitted token's gap to its position's largest logit under one
    prefill of the prompt and the tokens before it (no cache)."""
    seq = torch.tensor([row + gen[:-1]], device=dev)
    with torch.inference_mode():
        logits = model(seq)[0, len(row) - 1:]
    tok = torch.tensor(gen, device=dev)
    return (logits.amax(-1) - logits.gather(-1, tok[:, None])[:, 0]).tolist()


def metric_value(text, name):
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name + " "))


def pool_quantum_checks(torch, dev, model):
    """One quantum of the scheduler's ``pool_steps`` over a full pool (8
    live rows at depth 512), greedy and sampled, each enqueued under
    ``torch.cuda.set_sync_debug_mode("error")``, where any host read or
    sync inside the quantum raises; then each timed (host clock to a
    synchronize), and the greedy one profiled: kernels a step and the
    device's busy share of the quantum.  Last, the same 8 greedy steps on
    the lock path (request A's 4 rows over their 544-slot cache) and in
    the pool, in turns (lock, pool, pool, lock), seconds a step each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import (
        DecodeState,
        SamplingRows,
        decode_step,
        generate_prefill,
    )
    from kubeflow_tpu_torch.models.scheduler import pool_steps

    b, depth = POOL_SLOTS, 512
    out = {}
    with torch.inference_mode():
        st = DecodeState(
            cache=model.new_cache(b, POOL_SLOT_LEN),
            token=torch.zeros(b, dtype=torch.long, device=dev),
            pos=torch.full((b,), depth, dtype=torch.long, device=dev),
            done=torch.zeros(b, dtype=torch.bool, device=dev),
            pad_bias=torch.zeros(b, POOL_SLOT_LEN, device=dev),
            generators=[torch.Generator(device=dev).manual_seed(i)
                        for i in range(b)], budget=0)
        for kind, temp, top_k in (("greedy", 0.0, None),
                                  ("sampled", 0.8, 40)):
            rows = SamplingRows.make(b, dev, temp, top_k, None)
            write = torch.full((b,), depth, dtype=torch.long, device=dev)
            pool_steps(model, st, rows, write, 1)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                pool_steps(model, st, rows, write, POOL_QUANTUM)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool_steps(model, st, rows, write, POOL_QUANTUM)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out[kind] = {"no_host_sync": True,
                         "enqueue_seconds": t1 - t0,
                         "wall_seconds": time.perf_counter() - t0}
        rows = SamplingRows.make(b, dev, 0.0, None, None)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pool_steps(model, st, rows, write, POOL_QUANTUM)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    out["profiled_greedy"] = {"wall_seconds": wall_s,
                              "device_busy_seconds": busy_us / 1e6,
                              "device_busy_share": busy_us / 1e6 / wall_s,
                              "kernels_per_step": len(spans) / POOL_QUANTUM}
    _, prompt, mask = ragged_batch(torch, dev, model.cfg.vocab_size,
                                   PROMPT_LENS)
    _, lock = generate_prefill(model, prompt, prompt_mask=mask,
                               max_new_tokens=NEW_TOKENS)
    lock_rows = SamplingRows.make(len(PROMPT_LENS), dev, 0.0, None, None)

    def lock_quantum():
        for _ in range(POOL_QUANTUM):
            decode_step(model, lock, lock_rows)

    def pool_quantum():
        pool_steps(model, st, rows, write, POOL_QUANTUM)

    per_step = {"lock": [], "pool": []}
    with torch.inference_mode():
        for name, fn in (("lock", lock_quantum), ("pool", pool_quantum),
                         ("pool", pool_quantum), ("lock", lock_quantum)):
            lock.cache.index = prompt.shape[1]   # rewrite the same slots
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            per_step[name].append((time.perf_counter() - t0) / POOL_QUANTUM)
    out["seconds_per_step_in_turns"] = per_step
    return out


def phase_schedule(torch, dev, model):
    """The serve phase's llama3_8b behind the continuous-batching
    scheduler.  Returns the launch counts of the pooled HTTP run."""
    from kubeflow_tpu_torch.models.scheduler import DecodeScheduler
    from kubeflow_tpu_torch.models.serve import GenerationService, create_app
    from kubeflow_tpu_torch.ops import cuda as kernels

    cfg = model.cfg
    knobs = {"KFT_SERVE_SLOTS": str(POOL_SLOTS),
             "KFT_SERVE_SLOT_LEN": str(POOL_SLOT_LEN),
             "KFT_SERVE_DECODE_QUANTUM": str(POOL_QUANTUM)}
    saved_env = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    service = GenerationService(model, use_scheduler=True)
    server = create_app(service, model_name="llama3_8b").make_server(
        "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = schedule_bodies(torch, dev, cfg.vocab_size)
    row = {"phase": "schedule", "model": "llama3_8b", "slots": POOL_SLOTS,
           "slot_len": POOL_SLOT_LEN, "quantum": POOL_QUANTUM,
           "slot_len_note": f"KFT_SERVE_SLOT_LEN={POOL_SLOT_LEN} set by "
                            "this phase; the default is max_seq_len "
                            f"{cfg.max_seq_len}",
           "requests": {k: {"prompt_lens": list(v[0]), "max_new_tokens": v[1],
                            **v[2]} for k, v in SCHEDULE_REQUESTS.items()},
           "pool_bytes": 2 * cfg.n_layers * POOL_SLOTS * POOL_SLOT_LEN
           * cfg.n_kv_heads * cfg.head_dim * 2}
    try:
        status, ready = http(base, "/readyz")
        sched = service._scheduler
        if status != 200 or sched is None or not sched.pipeline:
            raise AssertionError(f"/readyz {status} {ready}: no pipelined "
                                 "scheduler behind the app")
        if (sched.slots, sched.slot_len, sched.quantum) != (
                POOL_SLOTS, POOL_SLOT_LEN, POOL_QUANTUM):
            raise AssertionError(f"scheduler knobs {sched.stats()}")
        before = wait_drained(sched)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            futs = {name: pool.submit(http, base, "/v1/generate", body)
                    for name, body in bodies.items()}
            pooled = {name: f.result()[1]["tokens"]
                      for name, f in futs.items()}
        wall_s = time.perf_counter() - t0
        after = wait_drained(sched)
        counts = kernels.launch_counts()
        row["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        prefills = after["prefills_total"] - before["prefills_total"]
        steps = after["steps_total"] - before["steps_total"]
        want = schedule_launches(cfg, prefills, steps)
        slack = schedule_launches(cfg, 0, POOL_QUANTUM)
        if any(abs(counts[k] - want[k]) > slack[k] for k in want) or not (
                counts["rms_norm"] and counts["flash_attention_fwd"]
                and counts["flash_decode"]):
            raise AssertionError(f"schedule launches {counts}, expected "
                                 f"{want} within one quantum")
        for name, body in bodies.items():
            out, n = pooled[name], body["max_new_tokens"]
            if len(out) != len(body["tokens"]) or any(
                    len(r) != n or not all(0 <= t < cfg.vocab_size
                                           for t in r) for r in out):
                raise AssertionError(f"request {name}: malformed {out}")
        _, traces = http(base, f"/debug/traces?n={len(bodies)}")
        ttft = {}
        for tr in traces["traces"]:
            spans = {sp["name"]: sp for sp in tr["spans"]}
            ttft[spans["decode"]["tokens"]] = (
                spans["prefill"]["offset_ms"]
                + spans["prefill"]["duration_ms"]) / 1e3
        decode_tokens = sum(len(b["tokens"]) * (b["max_new_tokens"] - 1)
                            for b in bodies.values())
        row.update({
            "wall_seconds": wall_s, "decode_tokens": decode_tokens,
            "decode_tokens_per_s": decode_tokens / wall_s,
            "ttft_seconds": {name: ttft.get(b["max_new_tokens"])
                             for name, b in bodies.items()},
            "launches": counts, "launches_expected": want,
            "prefills": prefills, "pool_steps": steps,
            "dispatch_overlap_ratio": after["dispatch_overlap_ratio"]})

        # Row independence: each request alone through the same pool.
        alone_s = {}
        for name, body in bodies.items():
            t1 = time.perf_counter()
            _, out = http(base, "/v1/generate", body)
            alone_s[name] = time.perf_counter() - t1
            if out["tokens"] != pooled[name]:
                raise AssertionError(f"request {name}: alone {out['tokens']} "
                                     f"differs from pooled {pooled[name]}")
        row["alone_seconds"] = alone_s
        wait_drained(sched)
        _, metrics = http(base, "/metrics")
        counters = {k: metric_value(metrics, k) for k in (
            "serve_scheduler_admitted_rows_total",
            "serve_scheduler_evicted_rows_total",
            "serve_decode_slots_active", "serve_queue_depth",
            "serve_decode_slots")}
        _, debug = http(base, "/debug/serve")
        row["counters"] = counters
        if (counters["serve_scheduler_admitted_rows_total"]
                != counters["serve_scheduler_evicted_rows_total"]
                or counters["serve_decode_slots_active"] != 0
                or counters["serve_queue_depth"] != 0
                or counters["serve_decode_slots"] != POOL_SLOTS
                or not sched.alive
                or service._scheduler_or_none() is not sched
                or debug["engine"] != "DecodeScheduler"):
            raise AssertionError(f"scheduler counters or state: {counters} "
                                 f"{debug}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if service._scheduler is not None:
        service._scheduler.stop()

    # Pipeline off, every request queued before the loop starts: the
    # launches are exact, and the tokens equal the pipelined run's.
    det = DecodeScheduler(model, slots=POOL_SLOTS, slot_len=POOL_SLOT_LEN,
                          quantum=POOL_QUANTUM, pipeline=False)
    start, det.start = det.start, lambda: None   # hold the loop
    kernels.reset_launch_counts()
    pend = {name: det.submit(
        b["tokens"], max_new_tokens=b["max_new_tokens"],
        temperature=b["temperature"], top_k=b.get("top_k"),
        seed=b.get("seed", 0)) for name, b in bodies.items()}
    t0 = time.perf_counter()
    det.start = start
    det.start()
    sync = {name: p.result() for name, p in pend.items()}
    det_s = time.perf_counter() - t0
    det_counts = kernels.launch_counts()
    st = det.stats()
    det.stop()
    want = schedule_launches(cfg, st["prefills_total"], st["steps_total"])
    if det_counts != want:
        raise AssertionError(f"schedule launches (pipeline off) {det_counts},"
                             f" expected {want}")
    if sync != pooled:
        raise AssertionError("pipeline off gave other tokens than on")
    row["pipeline_off"] = {"launches": det_counts, "prefills":
                           st["prefills_total"], "pool_steps":
                           st["steps_total"], "wall_seconds": det_s,
                           "tokens_equal": True}

    row["quantum"] = pool_quantum_checks(torch, dev, model)

    # Agreement with the lock path, teacher-forced.
    width = width_logit_diff(torch, dev, model, bodies["A"]["tokens"],
                             pooled["A"])
    tol = max(AGREE_GAP, 2 * width)
    gaps = []
    for name, body in bodies.items():
        if body["temperature"] != 0.0:
            continue
        for prompt, gen in zip(body["tokens"], pooled[name]):
            gaps += teacher_forced_gaps(torch, dev, model, prompt, gen)
    row["agreement"] = {"tokens": len(gaps),
                        "exact_argmax": sum(g <= 0.0 for g in gaps),
                        "worst_gap": max(gaps), "tolerance": tol,
                        "width_logit_diff": width}
    emit(row)
    if max(gaps) > tol:
        raise AssertionError(f"a pooled greedy token is {max(gaps)} below "
                             f"its position's largest logit (limit {tol})")
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_rel_l2(name, got, want, tol):
    """Relative L2 distance |got - want| / max(|want|, 1e-3 sqrt(n)) within
    ``tol``.  Returns (distance, share of the limit, max abs error)."""
    torch = sys.modules["torch"]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    scale = max(want.norm().item(), 1e-3 * math.sqrt(want.numel()))
    err = (got - want).norm().item() / scale
    if err > tol:
        raise AssertionError(f"{name}: relative L2 {err} beyond {tol}")
    return err, err / tol, (got - want).abs().max().item()


def check_lse(name, got, want):
    atol = KERNEL_TOL["flash_attention_fwd_lse"]
    diff = (got - want).abs().max().item()
    if not math.isfinite(diff) or diff > atol:
        raise AssertionError(f"{name}: lse max abs err {diff} beyond "
                             f"atol {atol}")
    return diff, diff / atol


def visible_pairs(torch, dev, b, sq, sk, h, causal, seg):
    """Visible (query, key) pairs summed over batch and q heads."""
    vis = torch.ones(sq, sk, dtype=torch.bool, device=dev)
    if causal:
        vis = torch.tril(vis, diagonal=sk - sq)
    if seg is None:
        return vis.sum().item() * b * h, vis
    vis = vis[None] & (seg[:, :, None] == seg[:, None, :])
    return vis.sum().item() * h, vis


def packed_segments(torch, dev, seq):
    """One row of segment ids as the trainer's packed loader makes them
    (documents of 8 to 256 tokens, seed 0)."""
    from kubeflow_tpu_torch.data.loader import synthetic_lm_documents
    from kubeflow_tpu_torch.data.packing import packed_lm_batches

    _, seg = next(packed_lm_batches(
        synthetic_lm_documents(vocab_size=32000, seed=SEED, max_len=256),
        batch_rows=1, seq_len=seq))
    return torch.from_numpy(seg).to(dev)


def train_kernel_case(torch, dev, gen, b, sq, sk, h, kvh, d, causal, seg,
                      g_lse):
    """Run K2-lse, K3 and K4 once and check each against its plain
    version in f32.  Returns the inputs, outputs and checks."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa

    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    q, k, v = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d)
    do = rnd(b, sq, h, d)
    gl = (torch.randn(b, h, sq, generator=gen, device=dev)
          if g_lse else None)
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, **kw)
    dq, delta = fa.flash_attention_dq(q, k, v, o, do, lse, g_lse=gl, **kw)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    # K3 sums a block's key tiles and K4 each GQA group in a fixed order,
    # without atomics: a second launch on the same inputs must repeat dq
    # and delta, dk and dv to the bit.
    dq2, delta2 = fa.flash_attention_dq(q, k, v, o, do, lse, g_lse=gl, **kw)
    dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        raise AssertionError("flash_attention_dq: a second launch on the "
                             "same inputs gave other dq/delta bits")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError("flash_attention_dkv: a second launch on the "
                             "same inputs gave other dk/dv bits")
    del dq2, delta2, dk2, dv2
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa.plain_attention_with_lse(*f32[:3], **kw)
    checks = {"o": check_close("flash_attention_fwd_lse o", o, o_ref,
                               KERNEL_TOL["flash_attention_fwd"]),
              "lse": check_lse("flash_attention_fwd_lse", lse, lse_ref)}
    del o_ref, lse_ref
    ref = fa.plain_attention_bwd(*f32, g_lse=gl, **kw)
    for name, got, want, kernel in (
            ("dq", dq, ref[0], "flash_attention_dq"),
            ("dk", dk, ref[1], "flash_attention_dkv"),
            ("dv", dv, ref[2], "flash_attention_dkv")):
        checks[name] = check_rel_l2(f"{kernel} {name}", got, want,
                                    KERNEL_TOL[kernel])
    del ref, f32
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta,
                checks=checks, bit_equal=True)


def rms_bwd_case(torch, dev, gen, rows, d, dt, st, kind=None):
    """Run the K1 backward twice on one case and check it against its
    plain version in f32 on the same inputs: dx elementwise at
    KERNEL_TOL["rms_norm_bwd"], dscale by relative L2 at
    KERNEL_TOL["rms_norm_bwd_dscale"], and both bit-equal on relaunch.
    ``kind``: "zero_row" zeroes x's rows 0 and rows // 2; "zero_g" makes
    the cotangent 0.  Returns the inputs and the checks."""
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    x = torch.randn(rows, d, generator=gen, device=dev).to(dt)
    g = torch.randn(rows, d, generator=gen, device=dev).to(dt)
    scale = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(st)
    if kind == "zero_row":
        x[0] = 0
        x[rows // 2] = 0
    elif kind == "zero_g":
        g.zero_()
    dx, ds = k1.rms_norm_bwd(x, scale, g, eps=1e-5)
    # dscale's sum runs in a fixed order over a fixed grid, no atomics: a
    # second launch must repeat dx and dscale to the bit.
    dx2, ds2 = k1.rms_norm_bwd(x, scale, g, eps=1e-5)
    torch.cuda.synchronize()
    if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
        raise AssertionError("rms_norm_bwd: a second launch on the same "
                             "inputs gave other dx/dscale bits")
    want_dx, want_ds = k1.rms_norm_backward(x.float(), scale.float(),
                                            g.float(), eps=1e-5)
    if dx.dtype != dt or ds.dtype != st:
        raise AssertionError(f"rms_norm_bwd: dtypes {dx.dtype} {ds.dtype}, "
                             f"expected {dt} {st}")
    checks = {"dx": check_close("rms_norm_bwd dx", dx, want_dx,
                                KERNEL_TOL["rms_norm_bwd"]),
              "dscale": check_rel_l2("rms_norm_bwd dscale", ds, want_ds,
                                     KERNEL_TOL["rms_norm_bwd_dscale"])}
    return dict(x=x, g=g, scale=scale, checks=checks, bit_equal=True)


def phase_train_kernels(torch, dev, timer):
    """K1 (forward and backward), K2-lse, K3 and K4 at the training path's
    shapes; returns the summary row per kernel at llama_1b4's shape."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.cuda import flash_attention as fa
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = {}
    # K1 at the training rows: b1 x s8192 tokens of llama_1b4's dim 2048.
    n, dm = TRAIN_SEQ, 2048
    x = torch.randn(n, dm, generator=gen, device=dev).to(torch.bfloat16)
    scale = (1.0 + 0.1 * torch.randn(dm, generator=gen, device=dev)).float()
    tol = KERNEL_TOL["rms_norm"]
    err, share = check_close("rms_norm", k1.rms_norm(x, scale, eps=1e-5),
                             k1.plain_rms_norm(x.float(), scale, eps=1e-5),
                             tol)
    bms, by = bound_ms(n * dm * 4 + dm * 4, 4 * n * dm, PEAK_F32_FLOPS)
    y = torch.empty_like(x)
    emit(add_rates({"kernel": "rms_norm", "shape": [n, dm], "path": "train",
          "max_abs_err": err, "tol": tol, "tol_share": share,
          "kernel_ms": timer(lambda: k1.rms_norm(x, scale, eps=1e-5)),
          "plain_ms": timer(lambda: k1.plain_rms_norm(x, scale, eps=1e-5)),
          "library_ms": timer(lambda: F.rms_norm(
              x, (dm,), weight=scale.to(torch.bfloat16), eps=1e-5)),
          "same_bytes_ms": timer(lambda: y.copy_(x)),
          "bound_ms": bms, "bound_by": by}, 4 * n * dm, timer.floor_ms))
    del x, y, scale
    # The K1 backward at the same rows, as the bf16-gradient step calls it
    # (x, g and the scale copy in bf16).  Bound: x, g and the scale read,
    # dx and dscale written (the kernel's f32 workspace, one row of d per
    # block, is not in it: ``workspace_bytes_at_most``); 11 f32 flops an
    # element (x^2 and g*s*x sums, dx = r*gs - x*c, dscale += g*x*r).
    bf = torch.bfloat16
    c = rms_bwd_case(torch, dev, gen, n, dm, bf, bf)
    x, g, scale = c["x"], c["g"], c["scale"]
    flops = 11 * n * dm
    bms, by = bound_ms(3 * n * dm * 2 + 2 * dm * 2, flops, PEAK_F32_FLOPS)
    # The library call: F.rms_norm's backward, through autograd on a
    # graph built once (timing only the backward).
    xl, wl = x.detach().requires_grad_(True), scale.detach().requires_grad_(
        True)
    lib_out = F.rms_norm(xl, (dm,), weight=wl, eps=1e-5)
    dx_out = torch.empty_like(x)
    row = {"kernel": "rms_norm_bwd", "shape": [n, dm], "path": "train",
           "dtypes": {"x": "bf16", "scale": "bf16"},
           "max_abs_err": c["checks"]["dx"][0],
           "tol": KERNEL_TOL["rms_norm_bwd"],
           "tol_share": c["checks"]["dx"][1],
           "dscale_rel_l2": c["checks"]["dscale"][0],
           "dscale_tol": KERNEL_TOL["rms_norm_bwd_dscale"],
           "dscale_tol_share": c["checks"]["dscale"][1],
           "bit_equal_on_relaunch": c["bit_equal"],
           "kernel_ms": timer(lambda: k1.rms_norm_bwd(x, scale, g,
                                                      eps=1e-5)),
           "plain_ms": timer(lambda: k1.rms_norm_backward(x, scale, g,
                                                          eps=1e-5)),
           "library_ms": timer(lambda: torch.autograd.grad(
               lib_out, (xl, wl), g, retain_graph=True)),
           "library": "F.rms_norm backward (dx, dweight)",
           "same_bytes_ms": timer(lambda: torch.add(x, g, out=dx_out)),
           "bound_ms": bms, "bound_by": by,
           "workspace_bytes_at_most": 2 * 4 * dm * k1.bwd_blocks(
               n, x.device)}
    emit(add_rates(row, flops, timer.floor_ms))
    rows["rms_norm_bwd"] = row
    del c, x, g, scale, xl, wl, lib_out, dx_out
    for name, (b, s, h, kvh, d, packed) in (
            ("llama_1b4", (1, 8192, 16, 16, 128, False)),
            ("llama_1b4 packed", (1, 8192, 16, 16, 128, True)),
            ("llama3_8b gqa", (1, 4096, 32, 8, 128, False))):
        seg = packed_segments(torch, dev, s) if packed else None
        c = train_kernel_case(torch, dev, gen, b, s, s, h, kvh, d, True,
                              seg, False)
        q, k, v, do, o, lse, delta = (c[x] for x in (
            "q", "k", "v", "do", "o", "lse", "delta"))
        kw = dict(causal=True, segment_ids=seg)
        pairs, vis = visible_pairs(torch, dev, b, s, s, h, True, seg)
        qkv_bytes = 2 * (b * s * h * d + 2 * b * s * kvh * d)
        qo_bytes = 2 * b * s * h * d          # one bf16 tensor of q's shape
        row_bytes = 4 * b * h * s             # one f32 [b, h, s]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        sdpa = (dict(is_causal=True) if seg is None
                else dict(attn_mask=vis[:, None]))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                 **sdpa)
        go = do.transpose(1, 2)
        lib_fwd = lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), enable_gqa=True, **sdpa)
        lib_bwd_ms = timer(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), go, retain_graph=True))
        shape = [b, s, h, kvh, d]
        out = {
            "flash_attention_fwd_lse": dict(
                check=c["checks"]["lse"], o_check=c["checks"]["o"],
                flops=4 * pairs * d,
                bound=bound_ms(qkv_bytes + qo_bytes + row_bytes,
                               4 * pairs * d, PEAK_BF16_FLOPS),
                ms=timer(lambda: fa.flash_attention_fwd_lse(q, k, v, **kw)),
                plain_ms=timer(lambda: fa.plain_attention_with_lse(
                    q, k, v, **kw)),
                library_ms=timer(lib_fwd)),
            "flash_attention_dq": dict(
                check=c["checks"]["dq"],
                flops=6 * pairs * d,
                bound=bound_ms(qkv_bytes + 3 * qo_bytes + 2 * row_bytes,
                               6 * pairs * d, PEAK_BF16_FLOPS),
                ms=timer(lambda: fa.flash_attention_dq(
                    q, k, v, o, do, lse, **kw)),
                plain_ms=timer(lambda: fa.plain_attention_dq(
                    q, k, v, o, do, lse, **kw)),
                library_ms=lib_bwd_ms),
            "flash_attention_dkv": dict(
                check=max(c["checks"]["dk"], c["checks"]["dv"],
                          key=lambda x: x[1]),
                flops=8 * pairs * d,
                bound=bound_ms(2 * qkv_bytes + 2 * row_bytes,
                               8 * pairs * d, PEAK_BF16_FLOPS),
                ms=timer(lambda: fa.flash_attention_dkv(
                    q, k, v, do, lse, delta, **kw)),
                plain_ms=timer(lambda: fa.plain_attention_dkv(
                    q, k, v, do, lse, delta, **kw)),
                library_ms=lib_bwd_ms),
        }
        for kernel, r in out.items():
            err, share = r["check"][:2]
            row = {"kernel": kernel, "shape": shape, "case": name,
                   "segments": packed, "path": "train",
                   "max_abs_err": (err if kernel.endswith("lse")
                                   else r["check"][2]),
                   "tol": KERNEL_TOL[kernel],
                   "tol_share": share, "kernel_ms": r["ms"],
                   "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                   "library": ("sdpa forward" if kernel.endswith("lse")
                               else "sdpa backward (dq, dk and dv)"),
                   "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                   "visible_pairs": pairs}
            if kernel.endswith("lse"):
                row["o_tol_share"] = r["o_check"][1]
            else:
                row["rel_l2"] = err
            if kernel == "flash_attention_dkv":
                row["dk_rel_l2"] = c["checks"]["dk"][0]
                row["dv_rel_l2"] = c["checks"]["dv"][0]
            if not kernel.endswith("lse"):
                row["bit_equal_on_relaunch"] = c["bit_equal"]
            emit(add_rates(row, r["flops"]))
            if name == "llama_1b4":
                rows[kernel] = row
        del c, q, k, v, do, o, lse, delta, qt, kt, vt, lib_out, go, vis
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase_train_edges(torch, dev):
    """The K1 backward and K2-lse, K3 and K4 beyond the training path's
    shapes, each against its plain version (untimed), the K1 backward, K3
    and K4 also against their own second launch (bit-equal).  K1
    backward: 1, 3 and 8193 rows and 1000 (not a multiple of the grid's
    rows), widths 64, 128, 4096, 8192 and 16384 (the widest bf16 row),
    f32 and bf16 with either scale dtype, rows of x that are all zero, a
    zero cotangent.  Attention: ragged and cross-length causal, head_dim
    64, one key, every GQA group size and GQA 8 at head_dim 64, lengths
    around K2's key tile and ring, K3's q tile, key tile and ring and K4's
    q tile and ring, sq 8191, nonzero g_lse, and segment ids with pads,
    drawn at random, permuted, or with a one-token segment
    (``edge_segments``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {}
    f32, bf = torch.float32, torch.bfloat16
    # (rows, d, x dtype, scale dtype, kind)
    rms_cases = [(n, 2048, bf, bf, None) for n in (1, 3, 1000, 8193)]
    rms_cases += [(33, d, dt, st, None) for d in (64, 128, 4096, 8192)
                  for dt, st in ((bf, bf), (f32, f32), (bf, f32))]
    rms_cases += [(5, 16384, bf, bf, None), (257, 2048, f32, bf, None),
                  (100, 2048, bf, bf, "zero_row"),
                  (100, 4096, f32, f32, "zero_row"),
                  (100, 4096, bf, f32, "zero_g")]
    for n, d, dt, st, kind in rms_cases:
        case = f"{n}x{d} {str(dt)[6:]} scale {str(st)[6:]} {kind}"
        c = rms_bwd_case(torch, dev, gen, n, d, dt, st, kind)
        for name, check in c["checks"].items():
            w = worst.setdefault(f"rms_norm_bwd {name}",
                                 {"cases": 0, "tol_share": 0.0})
            w["cases"] += 1
            if check[1] >= w["tol_share"]:
                w.update(tol_share=check[1], err=check[0], case=case)
        del c
    # (b, sq, sk, h, kv_h, d, causal, segments, g_lse)
    cases = [(2, 100, 100, 4, 2, 128, True, None, False),
             (2, 37, 200, 4, 1, 128, True, None, False),
             (1, 50, 130, 4, 2, 64, False, None, False),
             (2, 130, 130, 4, 4, 64, True, None, False),
             (1, 1, 1, 2, 1, 128, True, None, False),
             (2, 1, 70, 4, 2, 128, True, None, False)]
    cases += [(1, 96, 96, 8, 8 // g, 128, True, None, False)
              for g in (1, 2, 4, 8)]
    cases += [(2, 130, 130, 4, 2, 128, True, "pads", False),
              (1, 77, 77, 8, 2, 64, False, None, True),
              (2, 100, 100, 4, 2, 128, True, "pads", True)]
    lengths = sorted({1, K2_TILE - 1, K2_TILE, K2_TILE + 1,
                      K2_STAGES * K2_TILE + 1, K3_ROWS - 1, K3_ROWS,
                      K3_ROWS + 1, K3_KEYS - 1, K3_KEYS, K3_KEYS + 1,
                      K3_STAGES * K3_KEYS + 1, K4_ROWS - 1, K4_ROWS,
                      K4_ROWS + 1, K4_STAGES * K4_ROWS + 1, K4_KEYS + 1})
    cases += [(1, n, n, 4, 2, 128, True, None, False) for n in lengths]
    cases += [(1, 40, n, 4, 2, 64, False, None, False) for n in lengths]
    cases += [(1, 8191, 8191, 2, 1, 128, True, None, False),
              (1, 129, 300, 4, 2, 128, True, None, False),
              (2, 200, 200, 8, 1, 64, True, None, False),
              (2, 300, 300, 4, 2, 128, False, "blocks", False),
              (2, 300, 300, 4, 2, 128, True, "random", False),
              (1, 257, 257, 4, 4, 64, False, "random", True),
              (2, 300, 300, 4, 2, 128, True, "permuted", False),
              (1, 300, 300, 4, 2, 128, False, "lone", False)]
    for b, sq, sk, h, kvh, d, causal, segs, glse in cases:
        seg = edge_segments(torch, dev, gen, segs, b, sq)
        case = (f"b{b} sq{sq} sk{sk} h{h}/{kvh} d{d} causal={causal} "
                f"segments={segs} g_lse={glse}")
        c = train_kernel_case(torch, dev, gen, b, sq, sk, h, kvh, d, causal,
                              seg, glse)
        for name, check in c["checks"].items():
            share = check[1]
            w = worst.setdefault(name, {"cases": 0, "tol_share": 0.0})
            w["cases"] += 1
            if share >= w["tol_share"]:
                w.update(tol_share=share, err=check[0], case=case)
        del c
    emit({"phase": "train-edges", "cases": len(cases),
          "rms_norm_bwd_cases": len(rms_cases), "worst_by_output": worst})
    torch.cuda.empty_cache()


def phase_train_compose(torch, dev):
    """``llama_1b4`` at full width, 2 layers, the same f32 master weights
    three ways: the kernel route and the plain route computing in bf16
    with bf16 gradients (as the trainer runs), and an f32 plain model with
    f32 gradients as the reference.  One grad step on one b1 s8192 batch
    of the trainer's synthetic stream."""
    from kubeflow_tpu_torch.data.loader import synthetic_lm_batches
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.train.steps import TrainState, make_lm_grad_fn

    tokens = torch.from_numpy(next(synthetic_lm_batches(
        global_batch=1, seq_len=TRAIN_SEQ,
        vocab_size=CONFIGS[TRAIN_MODEL].vocab_size, seed=SEED))).to(dev)
    variants = {"kernel": (dict(impl="auto"), torch.bfloat16),
                "plain": (dict(impl="plain"), torch.bfloat16),
                "f32": (dict(impl="plain", dtype=torch.float32), None)}
    state = None
    grads, losses = {}, {}
    for name, (kw, grad_dtype) in variants.items():
        model = create_model(TRAIN_MODEL, device=dev, n_layers=2,
                             param_dtype=torch.float32, **kw)
        if state is None:
            with torch.no_grad():
                model.reset_parameters(
                    torch.Generator(device=dev).manual_seed(SEED))
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        g, m = make_lm_grad_fn(grad_dtype=grad_dtype)(
            TrainState(model, None), tokens)
        grads[name] = {n: t.float() for n, t in g.items()}
        losses[name] = m["loss"].item()
        del model, g
        torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    per_tensor, worst = {}, (0.0, "")
    for n, ref in grads["f32"].items():
        e_k = rel(grads["kernel"][n], ref)
        e_p = rel(grads["plain"][n], ref)
        if not math.isfinite(e_k):
            raise AssertionError(f"train-compose {n}: non-finite gradient")
        per_tensor[n] = {"kernel_vs_f32": e_k, "plain_vs_f32": e_p}
        if e_k / e_p > worst[0]:
            worst = (e_k / e_p, n)
    cat = lambda name: torch.cat([t.flatten() for t in grads[name].values()])
    row = {"phase": "train-compose", "model": TRAIN_MODEL, "n_layers": 2,
           "batch": [1, TRAIN_SEQ], "loss": losses,
           "all_grads_rel_l2_kernel_vs_f32": rel(cat("kernel"), cat("f32")),
           "all_grads_rel_l2_plain_vs_f32": rel(cat("plain"), cat("f32")),
           "worst_ratio": worst[0], "worst_tensor": worst[1],
           "ratio_limit": COMPOSE_RATIO, "per_tensor": per_tensor}
    emit(row)
    for name in ("kernel", "plain"):
        if not math.isfinite(losses[name]) or abs(
                losses[name] - losses["f32"]) > 1e-2 * abs(losses["f32"]):
            raise AssertionError(f"train-compose loss {losses}")
    if worst[0] > COMPOSE_RATIO:
        raise AssertionError(
            f"train-compose: {worst[1]} kernel-route gradient {worst[0]} x "
            f"the plain route's distance from f32, above {COMPOSE_RATIO}")
    del grads, state
    torch.cuda.empty_cache()


def phase_train_variants(torch, dev):
    """``llama_1b4`` at full width, 2 layers, kernel route, bf16 gradients:
    the step's other paths against the base step (b1, no remat, whole
    head) on the same weights and tokens, each with its exact launches
    per step and its peak memory.  Remat "block" and "mlp" and the chunked
    head and loss (``--ce-chunk``) are held against the base step;
    2 accumulated microbatches (``--grad-accum 2``) against the whole b2
    batch in one step."""
    from kubeflow_tpu_torch.data.loader import synthetic_lm_batches
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.train.steps import (
        TrainState,
        make_grad_accum_step,
        make_lm_grad_fn,
    )

    class Captured(TrainState):
        """Keeps the gradients the accumulating step would apply."""

        def apply_gradients(self, grads):
            self.grads = grads
            return self

    def grad_step(**kw):
        return make_lm_grad_fn(grad_dtype=torch.bfloat16, **kw)

    def accum_step(n):
        step = make_grad_accum_step(
            make_lm_grad_fn(grad_dtype=torch.bfloat16), n)

        def run(state, batch):
            state, metrics = step(state, batch)
            return state.grads, metrics
        return run

    n_layers = 2
    cfg = CONFIGS[TRAIN_MODEL]
    tokens = torch.from_numpy(next(synthetic_lm_batches(
        global_batch=2, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size,
        seed=SEED))).to(dev)
    base = train_launches_per_step(cfg, n_layers=n_layers)
    recompute = dict(base, rms_norm=base["rms_norm"] + 2 * n_layers,
                     flash_attention_fwd_lse=2 * n_layers)
    twice = {k: 2 * n for k, n in base.items()}
    # name: (model overrides, step, rows, reference, launches per step)
    variants = {
        "base": ({}, grad_step(), 1, None, base),
        "remat_block": (dict(remat=True, remat_mode="block"), grad_step(),
                        1, "base", recompute),
        "remat_mlp": (dict(remat=True, remat_mode="mlp"), grad_step(), 1,
                      "base", base),
        "ce_chunk_1024": ({}, grad_step(ce_chunk=1024), 1, "base", base),
        "base_b2": ({}, grad_step(), 2, None, base),
        "grad_accum_2": ({}, accum_step(2), 2, "base_b2", twice),
    }
    cat = lambda v: torch.cat([t.flatten() for t in grads[v].values()])
    state = None
    grads, rows = {}, {}
    for name, (kw, step, n_rows, ref, want) in variants.items():
        # Peak memory of the variant's model and step, above what the
        # phase already holds (the weights and earlier gradients).
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = create_model(TRAIN_MODEL, device=dev, n_layers=n_layers,
                             param_dtype=torch.float32, **kw)
        if state is None:
            with torch.no_grad():
                model.reset_parameters(
                    torch.Generator(device=dev).manual_seed(SEED))
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        kernels.reset_launch_counts()
        g, m = step(Captured(model, None), tokens[:n_rows])
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() - held
        grads[name] = {n: t.float() for n, t in g.items()}
        rows[name] = {"loss": m["loss"].item(), "launches": counts,
                      "peak_bytes": peak}
        if counts != want:
            raise AssertionError(
                f"train-variants {name}: launches {counts}, expected {want}")
        if not math.isfinite(rows[name]["loss"]):
            raise AssertionError(f"train-variants {name}: loss not finite")
        if ref is not None:
            rows[name]["reference"] = ref
            rows[name]["loss_rel_diff"] = abs(
                rows[name]["loss"] - rows[ref]["loss"]) / rows[ref]["loss"]
            rows[name]["grads_rel_l2"] = ((cat(name) - cat(ref)).norm()
                                          / cat(ref).norm()).item()
        del model, g
        torch.cuda.empty_cache()
    emit({"phase": "train-variants", "model": TRAIN_MODEL,
          "n_layers": n_layers, "seq": TRAIN_SEQ, "tol": VARIANT_TOL,
          "variants": rows})
    for name, row in rows.items():
        if "reference" not in row:
            continue
        loss_tol, grad_tol = VARIANT_TOL[name]
        if row["loss_rel_diff"] > loss_tol or row["grads_rel_l2"] > grad_tol:
            raise AssertionError(
                f"train-variants {name}: loss off by {row['loss_rel_diff']} "
                f"(limit {loss_tol}), gradients by {row['grads_rel_l2']} "
                f"(limit {grad_tol}) from {row['reference']}")
    del grads, state
    torch.cuda.empty_cache()


def run_trainer(argv):
    """``train.run.main(argv)`` with its standard output captured; returns
    the exit code and the parsed ``train_step`` lines."""
    from kubeflow_tpu_torch.train import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    lines = buf.getvalue().splitlines()
    steps = []
    for line in lines:
        if line.startswith("train_step "):
            kv = dict(p.split("=", 1) for p in line.split()[1:])
            steps.append({k: float(v) for k, v in kv.items()})
    if rc != 0 or not lines or not lines[-1].startswith("done: step "):
        raise AssertionError(f"trainer exited {rc}: {lines[-3:]}")
    return steps, lines[-1]


def train_launches_per_step(cfg, n_layers=None):
    """Launches a step per wrapper: two norms a layer and the final one,
    each run forward and backward once; one attention a layer."""
    n = cfg.n_layers if n_layers is None else n_layers
    return {"rms_norm": 2 * n + 1, "rms_norm_bwd": 2 * n + 1,
            "flash_attention_fwd": 0,
            "flash_attention_fwd_lse": n, "flash_attention_dq": n,
            "flash_attention_dkv": n, "flash_decode": 0}


def profile_train_step(torch, argv):
    """Build the trainer as ``main`` does, run two steps, then one step
    under torch.profiler: its wall time, device kernel time by class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.train import run

    _, args = run.parse_args(argv)
    state, step, batches = run.build_lm(args, torch.device("cuda"))
    it = iter(batches(0))
    for _ in range(2):
        state, m = step(state, next(it))
    m["loss"].item()
    batch = next(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    classes = {"flash_attention_fwd_lse": 0.0, "flash_attention_dq": 0.0,
               "flash_attention_dkv": 0.0, "rms_norm": 0.0,
               "rms_norm_bwd": 0.0, "matmul": 0.0, "optimizer": 0.0,
               "other": 0.0}
    by_name, spans = {}, []
    for e in prof.events():
        # A user annotation on the device timeline (the optimizer's
        # "Optimizer.step#AdamW.step") spans kernels counted on their own.
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False) or "#" in e.name:
            continue
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
        if "flash_fwd_kernel" in name:
            classes["flash_attention_fwd_lse"] += us
        elif "flash_bwd_dq_kernel" in name:
            classes["flash_attention_dq"] += us
        elif "flash_bwd_dkv_kernel" in name:
            classes["flash_attention_dkv"] += us
        elif "rms_norm_bwd" in name:     # the row kernel and its sum
            classes["rms_norm_bwd"] += us
        elif "rms_norm_kernel" in name:
            classes["rms_norm"] += us
        elif any(t in name.lower() for t in ("gemm", "gemv", "cutlass",
                                             "xmma", "cublas", "nvjet")):
            classes["matmul"] += us
        elif "multi_tensor_apply" in name:   # the foreach AdamW update
            classes["optimizer"] += us
        else:
            classes["other"] += us
    # Busy time is the union of the device intervals: activities that
    # overlap (a copy beside a kernel) count once.
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    del state, step, batches, it, batch, prof
    return {"wall_seconds": wall_s,
            "device_kernel_seconds": sum(classes.values()) / 1e6,
            "device_busy_seconds": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "device_kernels": len(spans),
            "device_ms_by_class": {k: v / 1e3 for k, v in classes.items()},
            "top_kernels": [{"name": name[:90], "ms": t / 1e3, "count": c}
                            for name, (t, c) in top]}


def phase_train(torch):
    """The trainer's main path, then a profiled step, then the packed
    run.  Returns the launch counts of the 6-step run."""
    from kubeflow_tpu_torch.models.llama import CONFIGS
    from kubeflow_tpu_torch.ops import cuda as kernels
    from kubeflow_tpu_torch.telemetry import compute as ctel

    cfg = CONFIGS[TRAIN_MODEL]
    n_steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    steps, done = run_trainer(TRAIN_ARGS)
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: n * n_steps for k, n in train_launches_per_step(cfg).items()}
    if counts != want:
        raise AssertionError(f"train launch counts {counts}, expected {want}")
    losses = [s["loss"] for s in steps]
    if len(steps) != n_steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_train_step(torch, TRAIN_ARGS)
    steady = steps[1:]
    step_s = statistics.median(s["step_seconds"] for s in steady)
    fpt = ctel.lm_train_flops_per_token(cfg, TRAIN_SEQ)
    emit({"phase": "train", "model": TRAIN_MODEL, "args": TRAIN_ARGS,
          "n_layers": cfg.n_layers, "losses": losses,
          "step_seconds": [s["step_seconds"] for s in steps],
          "median_step_seconds_2_to_6": step_s,
          "tokens_per_sec": TRAIN_SEQ / step_s,
          "mfu": ctel.mfu(TRAIN_SEQ / step_s, fpt), "flops_per_token": fpt,
          "mfu_peak_tflops": ctel.H100_SXM_BF16_PEAK_TFS,
          "wall_seconds_with_build": wall_s,
          "max_memory_allocated_bytes": peak,
          "launches": counts,
          "launches_per_step": train_launches_per_step(cfg),
          "profiled_step": prof, "done": done})
    gc.collect()
    torch.cuda.empty_cache()

    n_packed = int(PACKED_ARGS[PACKED_ARGS.index("--steps") + 1])
    kernels.reset_launch_counts()
    steps_p, done_p = run_trainer(PACKED_ARGS)
    counts_p = kernels.launch_counts()
    want_p = {k: n * n_packed
              for k, n in train_launches_per_step(cfg).items()}
    losses_p = [s["loss"] for s in steps_p]
    if counts_p != want_p:
        raise AssertionError(f"packed launch counts {counts_p}, "
                             f"expected {want_p}")
    if len(steps_p) != n_packed or not all(math.isfinite(x)
                                           for x in losses_p):
        raise AssertionError(f"packed losses {losses_p}")
    emit({"phase": "train-packed", "args": PACKED_ARGS, "losses": losses_p,
          "step_seconds": [s["step_seconds"] for s in steps_p],
          "launches": counts_p, "done": done_p})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def ckpt_state(torch, dev, n_layers):
    """A fresh ``llama_1b4`` train state as the trainer builds it (f32
    masters from seed SEED, AdamW at its default lr)."""
    from kubeflow_tpu_torch.models import create_model
    from kubeflow_tpu_torch.train.steps import TrainState, adamw

    model = create_model(TRAIN_MODEL, device=dev, n_layers=n_layers,
                         max_seq_len=TRAIN_SEQ, param_dtype=torch.float32)
    with torch.no_grad():
        model.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    model.requires_grad_(True)
    return TrainState(model, adamw(model.parameters(), 3e-4))


def ckpt_batches(dev):
    """The trainer's step-indexed stream (b1 TRAIN_SEQ), from a step."""
    from kubeflow_tpu_torch.data.loader import DeviceLoader, synthetic_lm_batches
    from kubeflow_tpu_torch.models.llama import CONFIGS

    return lambda start=0: DeviceLoader(synthetic_lm_batches(
        global_batch=1, seq_len=TRAIN_SEQ,
        vocab_size=CONFIGS[TRAIN_MODEL].vocab_size, seed=SEED,
        start=start), dev)


def ckpt_run(torch, dev, state, total, ckpt=None, stop=None, at_log=None):
    """``train_loop`` for ``total`` steps (bf16 gradients, a log line and
    with ``ckpt`` a save every 2 steps); returns (state, losses)."""
    from kubeflow_tpu_torch.train.loop import LoopConfig, train_loop
    from kubeflow_tpu_torch.train.steps import make_lm_train_step

    losses = []

    def on_log(step, vals):
        losses.append(vals["loss"])
        if at_log is not None:
            at_log(step)

    with contextlib.redirect_stdout(io.StringIO()):
        state, _ = train_loop(
            state, make_lm_train_step(grad_dtype=torch.bfloat16),
            ckpt_batches(dev),
            LoopConfig(total_steps=total, log_every=1, checkpoint_dir=ckpt,
                       checkpoint_every=2),
            stop=stop, on_log=on_log)
    return state, losses


def state_copy(state):
    """(parameters, optimizer state by index, step), cloned."""
    return ({n: p.detach().clone() for n, p in
             state.module.named_parameters()},
            {i: {k: v.clone() for k, v in per.items()}
             for i, per in state.optimizer.state_dict()["state"].items()},
            state.step)


def state_diff(a, b):
    """Largest |difference| over parameters and AdamW moments (and the
    step counts, which must match)."""
    if a[2] != b[2] or set(a[0]) != set(b[0]) or set(a[1]) != set(b[1]):
        return math.inf
    worst = 0.0
    for name in a[0]:
        worst = max(worst, (a[0][name] - b[0][name]).abs().max().item())
    for i in a[1]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            worst = max(worst, (a[1][i][k].float()
                                - b[1][i][k].float()).abs().max().item())
    return worst


def checkpoint_root():
    """Where checkpoints go: a git-ignored directory of this checkout."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "checkpoints")
    os.makedirs(root, exist_ok=True)
    return root


def phase_checkpoint(torch, dev):
    """(a) ``llama_1b4`` at full width, 2 layers: save, stop, resume
    against unbroken runs; (b) all 24 layers through ``train.run`` with
    ``--checkpoint-dir``, restored by ``load_service`` and served through
    the scheduler."""
    from kubeflow_tpu_torch.models.generate import generate, row_generators
    from kubeflow_tpu_torch.models.serve import create_app, load_service
    from kubeflow_tpu_torch.train import run
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.train.steps import make_lm_train_step

    root = checkpoint_root()
    usage = shutil.disk_usage(root)
    emit({"phase": "checkpoint-disk", "path": root, "free_bytes": usage.free,
          "total_bytes": usage.total})
    tmp = tempfile.mkdtemp(prefix="chip-smoke-", dir=root)
    try:
        # (a) 4 unbroken steps, twice; 2 steps, a stop, a resume for 2.
        runs = []
        for _ in range(2):
            state, losses = ckpt_run(torch, dev, ckpt_state(torch, dev, 2), 4)
            runs.append((state_copy(state), losses))
            del state
        unbroken_diff = state_diff(runs[0][0], runs[1][0])
        stop = threading.Event()
        run_dir = os.path.join(tmp, "run")
        state, losses_b = ckpt_run(
            torch, dev, ckpt_state(torch, dev, 2), 4, ckpt=run_dir,
            stop=stop, at_log=lambda step: step == 2 and stop.set())
        if state.step != 2 or CheckpointManager(run_dir).all_steps() != [2]:
            raise AssertionError(f"stop at step {state.step}, saved "
                                 f"{CheckpointManager(run_dir).all_steps()}")
        saved = state_copy(state)
        fresh = ckpt_state(torch, dev, 2)
        CheckpointManager(run_dir).restore(fresh)
        restored_diff = state_diff(state_copy(fresh), saved)
        del fresh
        # The snapshot rule: training goes on in place while the write
        # runs, and the restored state is still the saved one.
        snap = CheckpointManager(os.path.join(tmp, "snap"))
        t0 = time.perf_counter()
        snap.save(2, state)
        save_return_s = time.perf_counter() - t0
        batch = next(iter(ckpt_batches(dev)(2)))
        state, _ = make_lm_train_step(grad_dtype=torch.bfloat16)(state, batch)
        torch.cuda.synchronize()
        snap.wait()
        fresh = ckpt_state(torch, dev, 2)
        snap.restore(fresh)
        snapshot_diff = state_diff(state_copy(fresh), saved)
        moved = max((p.detach() - saved[0][n]).abs().max().item()
                    for n, p in state.module.named_parameters())
        del state, fresh, saved
        resumed, losses_c = ckpt_run(torch, dev, ckpt_state(torch, dev, 2), 4,
                                     ckpt=run_dir)
        resumed_diff = state_diff(state_copy(resumed), runs[0][0])
        del resumed
        loss_diff_unbroken = max(abs(x - y) for x, y in zip(runs[0][1],
                                                            runs[1][1]))
        loss_diff_resumed = max(abs(x - y) for x, y in zip(
            losses_b + losses_c, runs[0][1]))
        row = {"phase": "checkpoint-resume", "model": TRAIN_MODEL,
               "n_layers": 2, "seq": TRAIN_SEQ,
               "losses_unbroken": runs[0][1],
               "losses_stopped_then_resumed": losses_b + losses_c,
               "restored_vs_saved_max_diff": restored_diff,
               "restored_while_training_went_on_max_diff": snapshot_diff,
               "params_moved_after_save": moved,
               "save_returned_seconds": save_return_s,
               "last_save": snap.last_save,
               "unbroken_vs_unbroken_max_diff": unbroken_diff,
               "resumed_vs_unbroken_max_diff": resumed_diff,
               "loss_diff_unbroken_vs_unbroken": loss_diff_unbroken,
               "loss_diff_resumed_vs_unbroken": loss_diff_resumed}
        emit(row)
        del runs
        gc.collect()
        torch.cuda.empty_cache()
        if restored_diff != 0.0 or snapshot_diff != 0.0 or moved == 0.0:
            raise AssertionError("a restored state differs from the saved "
                                 "one (or training did not go on)")
        if resumed_diff > unbroken_diff or \
                loss_diff_resumed > loss_diff_unbroken:
            raise AssertionError(
                f"resumed run off by {resumed_diff} (loss {loss_diff_resumed})"
                f", two unbroken runs by {unbroken_diff} "
                f"(loss {loss_diff_unbroken})")

        # (b) the whole model through the trainer, then served.
        full_dir = os.path.join(tmp, "full")
        argv = TRAIN_ARGS[:TRAIN_ARGS.index("--steps")] + [
            "--steps", "3", "--log-every", "1", "--checkpoint-dir", full_dir]
        _, args = run.parse_args(argv)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state, _ = run.train(args, dev)
        train_s = time.perf_counter() - t0
        saves = [dict(kv.split("=", 1) for kv in line.split()[1:])
                 for line in buf.getvalue().splitlines()
                 if line.startswith("checkpoint ")]
        steps_on_disk = CheckpointManager(full_dir).all_steps()
        disk_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(full_dir) for f in fs)
        if steps_on_disk != [3] or len(saves) != 1:
            raise AssertionError(f"trainer saved {steps_on_disk}: {saves}")
        t0 = time.perf_counter()
        service = load_service(TRAIN_MODEL, checkpoint_dir=full_dir,
                               use_scheduler=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        served = service.model.state_dict()
        trained = dict(state.module.named_parameters())
        unequal = [n for n, p in trained.items()
                   if not torch.equal(served[n], p.detach().to(
                       served[n].dtype))]
        del state, trained
        gc.collect()
        torch.cuda.empty_cache()
        if unequal or set(served) != set(
                dict(service.model.named_parameters())):
            raise AssertionError(f"restored parameters differ: {unequal}")
        # One request through the scheduler, at the width and cache
        # length generate() runs it at, so the two match to the bit.
        import numpy as np

        prompt = np.random.RandomState(SEED + 20).randint(
            0, service.model.cfg.vocab_size, size=100).tolist()
        n = 32
        knobs = {"KFT_SERVE_SLOTS": "1",
                 "KFT_SERVE_SLOT_LEN": str(len(prompt) + n)}
        saved_env = {k: os.environ.get(k) for k in knobs}
        os.environ.update(knobs)
        try:
            create_app(service, model_name=TRAIN_MODEL)
            got = service.generate([prompt], max_new_tokens=n)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        sched = service._scheduler
        st = sched.stats() if sched is not None else None
        if sched is not None:
            sched.stop()
        want = generate(service.model, torch.tensor([prompt], device=dev),
                        max_new_tokens=n,
                        generators=row_generators(0, 1, dev)).tolist()
        emit({"phase": "checkpoint-serve", "model": TRAIN_MODEL,
              "n_layers": service.model.cfg.n_layers, "args": argv,
              "train_seconds_with_save": train_s, "save": saves[0],
              "bytes_on_disk": disk_bytes, "restore_seconds": restore_s,
              "restored_params_equal": True, "scheduler": st,
              "tokens_equal_generate": got == want,
              "row0_head": got[0][:8]})
        if st is None or st["evicted_total"] != 1 or got != want:
            raise AssertionError(f"served {got} through {st}, generate() "
                                 f"gives {want}")
        del service, served
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


SOURCES = {
    "rms_norm": ("kubeflow_tpu_torch/ops/csrc/rms_norm.cu",
                 "kubeflow_tpu/ops/pallas/rms_norm.py:53"),
    "rms_norm_bwd": ("kubeflow_tpu_torch/ops/csrc/rms_norm.cu",
                     "kubeflow_tpu/ops/pallas/rms_norm.py:91"),
    "flash_attention_fwd": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:151"),
    "flash_attention_fwd_lse": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:214"),
    "flash_attention_dq": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:391"),
    "flash_attention_dkv": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:424"),
    "flash_decode": ("kubeflow_tpu_torch/ops/csrc/flash_decode.cu",
                     "kubeflow_tpu/ops/pallas/flash_decode.py:94"),
}
# The path each kernel's ``launches`` is read from (K1 runs on both; its
# train count is in ``launches_by_path``).
TRAIN_KERNELS = ("rms_norm_bwd", "flash_attention_fwd_lse",
                 "flash_attention_dq", "flash_attention_dkv")


def main() -> int:
    import torch

    import kubeflow_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_device(torch)
    dev = torch.device("cuda")
    phase_build()
    timer = Timer(torch, dev)
    rows = phase_kernels(torch, dev, timer)
    phase_edges(torch, dev)
    rows.update(phase_train_kernels(torch, dev, timer))
    phase_train_edges(torch, dev)
    del timer
    torch.cuda.empty_cache()
    phase_compose(torch, dev)
    serve_counts, model = phase_serve(torch, dev)
    phase_profile(torch, dev, model)
    schedule_counts = phase_schedule(torch, dev, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_compose(torch, dev)
    phase_train_variants(torch, dev)
    train_counts = phase_train(torch)
    phase_checkpoint(torch, dev)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1],
        "launches": (train_counts if name in TRAIN_KERNELS
                     else serve_counts)[name],
        "launches_by_path": {"serve": serve_counts[name],
                             "schedule": schedule_counts[name],
                             "train": train_counts[name]},
        "shape": rows[name]["shape"], "max_abs_err": rows[name]["max_abs_err"],
        "ms": rows[name]["kernel_ms"], "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"]} for name in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
