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
   that computes the same function (a yardstick the port never calls).
   Then the shapes the kernels accept beyond the serving path's.
4. compose: ``llama3_8b`` at full width, 2 layers, on the card: the
   kernel route (impl="auto") against impl="plain" on the logits of a
   ragged batch, after prefill and after one decode step.
5. serve:   ``load_service("llama3_8b")`` (32 layers, random bf16 weights
   from seed 0 on the card) behind the HTTP app; /readyz, then three
   POST /v1/generate: A greedy, B sampled, C = A again (token-identical).
   The kernels' launch counts are set to 0 just before A and read just
   after it; each must equal what the path launches.

Every line of standard output is one JSON object; the line before the
last lists every kernel with its launches, error and times, and the last
line is the result, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

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
KERNEL_TOL = {"rms_norm": 1e-2, "flash_attention_fwd": 2e-2,
              "flash_decode": 1e-2}
# Composition: the bf16 kernel route's relative L2 distance from the same
# model in f32 may be at most this multiple of the bf16 plain route's.
# Both routes round to bf16 at the same places except inside attention
# (the kernels keep P unnormalised in bf16 at prefill and in f32 at
# decode), so an honest kernel route sits about as far from f32 as the
# plain one; a wrong mask or scale would put it many times farther.
COMPOSE_RATIO = 1.5

# Serving phase: 4 right-padded rows, max_new_tokens 32.
PROMPT_LENS = (17, 128, 300, 512)
NEW_TOKENS = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, flops_peak: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """CUDA-event timing of one call's device time: median over runs.
    Before each run a 64 MiB write evicts the inputs from L2 (the serving
    path evicts them between uses: a layer's weights are larger than L2),
    then a ~1 ms device-side sleep lets the host enqueue the call before
    the start event fires, so host overhead stays out of the reading."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

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
        bms, by = bound_ms(nbytes, 4 * nrows * d, PEAK_F32_FLOPS)
        row = {"kernel": "rms_norm", "shape": [nrows, d], "path": where,
               "max_abs_err": err, "tol": tol, "tol_share": share,
               "kernel_ms": timer(lambda: k1.rms_norm(x, scale, eps=1e-5)),
               "plain_ms": timer(lambda: k1.plain_rms_norm(x, scale,
                                                           eps=1e-5)),
               "library_ms": timer(lambda: F.rms_norm(
                   x, (d,), weight=scale.to(bf), eps=1e-5)),
               "bound_ms": bms, "bound_by": by}
        emit(row)
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
        bms, by = bound_ms(nbytes, 4 * pairs * hd, PEAK_BF16_FLOPS)
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
        emit(row)
        if s == 512 and not packed:
            rows["flash_attention_fwd"] = row

    # K5: one decode token over S = prompt + 32 slots, padded rows masked.
    for S in (512 + NEW_TOKENS, 1000):
        q = rnd(b, 1, h, hd)
        k, v = rnd(b, S, kvh, hd), rnd(b, S, kvh, hd)
        valid = torch.arange(S, device=dev)[None] < torch.tensor(
            [[17], [128], [300], [S]], device=dev)
        bias = torch.where(valid, 0.0, -1e30).float().contiguous()
        got = k5.flash_decode(q, k, v, bias)
        want = k5.plain_decode(q.float(), k.float(), v.float(), bias)
        tol = KERNEL_TOL["flash_decode"]
        err, share = check_close("flash_decode", got, want, tol)
        nbytes = 2 * b * S * kvh * hd * 2 + b * S * 4 + 2 * b * h * hd * 2
        bms, by = bound_ms(nbytes, 4 * b * h * S * hd, PEAK_BF16_FLOPS)
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
        emit(row)
        if S == 512 + NEW_TOKENS:
            rows["flash_decode"] = row
    return rows


def phase_edges(torch, dev):
    """The shapes the kernels accept beyond the serving path's, each
    against its plain version (untimed): f32 and narrow/wide rows for K1;
    head_dim 64, no mask, cross-length causal, one query or one key,
    single-row segments for K2; every GQA group size, head_dim 64 and
    ragged chunk tails for K5."""
    from kubeflow_tpu_torch.ops.cuda import flash_attention as k2
    from kubeflow_tpu_torch.ops.cuda import flash_decode as k5
    from kubeflow_tpu_torch.ops.cuda import rms_norm as k1

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(
        *s, generator=gen, device=dev).to(dt)
    # Per kernel: cases run, and the case that used most of its limit.
    worst = {name: {"cases": 0, "tol": tol, "tol_share": 0.0}
             for name, tol in KERNEL_TOL.items()}

    def check(kernel, case, got, want):
        err, share = check_close(f"{kernel} {case}", got, want,
                                 KERNEL_TOL[kernel])
        w = worst[kernel]
        w["cases"] += 1
        if share >= w["tol_share"]:
            w.update(tol_share=share, max_abs_err=err, case=case)

    for rows, d, dt in ((5, 8, torch.float32), (3, 4104, torch.bfloat16),
                        (7, 4096, torch.float32)):
        x, scale = rnd(rows, d, dt=dt), rnd(d, dt=torch.float32)
        check("rms_norm", f"{rows}x{d} {str(dt)[6:]}", k1.rms_norm(x, scale),
              k1.plain_rms_norm(x.float(), scale))
    # (b, sq, sk, h, kv_h, d, causal, segments)
    for b, sq, sk, h, kvh, d, causal, segs in (
            (2, 100, 100, 4, 4, 64, True, False),
            (1, 77, 77, 8, 2, 128, False, False),
            (2, 37, 200, 4, 1, 128, True, False),
            (1, 1, 1, 2, 1, 128, True, False),
            (2, 1, 130, 4, 2, 64, True, False),
            (1, 130, 130, 4, 2, 128, True, True)):
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d)
        seg = None
        if segs:
            seg = (torch.arange(sq, device=dev)[None] // 50 + 1).expand(
                b, sq).contiguous()
        check("flash_attention_fwd",
              f"b{b} sq{sq} sk{sk} h{h}/{kvh} d{d} causal={causal} "
              f"segments={segs}",
              k2.flash_attention(q, k, v, causal=causal, segment_ids=seg),
              k2.plain_attention(q.float(), k.float(), v.float(),
                                 causal=causal, segment_ids=seg))
    # (b, S, h, kv_h, d)
    for b, S, h, kvh, d in ((3, 1, 8, 8, 128), (2, 63, 4, 2, 64),
                            (2, 65, 8, 2, 128), (1, 300, 8, 1, 64),
                            (2, 129, 16, 2, 128)):
        q, k, v = rnd(b, 1, h, d), rnd(b, S, kvh, d), rnd(b, S, kvh, d)
        bias = torch.where(torch.arange(S, device=dev)[None] % 3 == 1,
                           -1e30, 0.0).expand(b, S).contiguous().float()
        check("flash_decode", f"b{b} S{S} h{h}/{kvh} d{d}",
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
    service = load_service("llama3_8b", device="cuda", seed=SEED)
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
                "flash_attention_fwd": cfg.n_layers,
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
        emit({"phase": "serve", "model": "llama3_8b",
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
        elif "decode_split" in name or "decode_merge" in name:
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


SOURCES = {
    "rms_norm": ("kubeflow_tpu_torch/ops/csrc/rms_norm.cu",
                 "kubeflow_tpu/ops/pallas/rms_norm.py:53"),
    "flash_attention_fwd": (
        "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "kubeflow_tpu/ops/pallas/flash_attention.py:151"),
    "flash_decode": ("kubeflow_tpu_torch/ops/csrc/flash_decode.cu",
                     "kubeflow_tpu/ops/pallas/flash_decode.py:94"),
}


def main() -> int:
    import torch

    import kubeflow_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_device(torch)
    dev = torch.device("cuda")
    phase_build()
    timer = Timer(torch, dev)
    rows = phase_kernels(torch, dev, timer)
    phase_edges(torch, dev)
    del timer
    torch.cuda.empty_cache()
    phase_compose(torch, dev)
    counts, model = phase_serve(torch, dev)
    phase_profile(torch, dev, model)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": counts[name],
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
