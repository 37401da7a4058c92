"""``torch.profiler`` capture for training steps — counterpart of
``kubeflow_tpu/train/profiling.py``.

* ``profile_trace(logdir)``: a context manager that records the enclosed
  region (host ops, and the card's kernels when there is one) and writes
  it as a Chrome trace, ``<logdir>/<host>.<pid>.<ns>.pt.trace.json``
  (TensorBoard's profile plugin and ``chrome://tracing`` read it).
* ``profile_steps(logdir, step_fn, *args, warmup, steps)``: warm up, then
  trace ``steps`` calls.
* ``trace_summary(logdir)``: the newest trace's device milliseconds by
  kernel class, and the FLOPs the profiler counted where it counted any.

``start_trace``/``Capture.stop`` are the two halves of
``profile_trace``, for the loop's one-shot capture of the step after a
slow one (``train/loop.py``).
"""
from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import socket
import time
from typing import Any, Callable, Dict, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

log = logging.getLogger("kubeflow_tpu_torch.train.profiling")

TRACE_SUFFIX = ".pt.trace.json"
FLOPS_SUFFIX = ".flops.json"

# Kernel class by a substring of the kernel's name, tried in this order:
# the port's flash kernels, convolutions (cuDNN's), matrix products
# (cuBLAS/CUTLASS), then elementwise and reduction kernels.
KERNEL_CLASSES = (
    ("flash", ("flash_fwd_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel", "flash_decode")),
    ("conv", ("conv", "dgrad", "wgrad", "fprop", "implicit_convolve",
              "winograd")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet",
              "matmul")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "batch_norm",
                     "bn_fw", "bn_bw", "layer_norm", "softmax", "pool",
                     "multi_tensor_apply", "copy", "fill", "cat")),
)
CLASSES = tuple(name for name, _ in KERNEL_CLASSES) + ("other",)
# The summary also lists the kernels (or host ops) with the most time.
TOP_KERNELS = 10


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, needles in KERNEL_CLASSES:
        if any(n in low for n in needles):
            return cls
    return "other"


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Capture:
    """A running profile; ``stop()`` ends it and writes its trace."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = None
        self._prof = profile(activities=_activities(), with_flops=True)
        self._prof.__enter__()

    def stop(self) -> str:
        """End the capture and write the Chrome trace, and beside it the
        FLOPs the profiler counted (``<trace>.flops.json``: the Chrome
        trace does not carry them); returns the trace's path."""
        self._prof.__exit__(None, None, None)
        stem = os.path.join(self.logdir, f"{socket.gethostname()}."
                            f"{os.getpid()}.{time.time_ns()}")
        self.path = stem + TRACE_SUFFIX
        self._prof.export_chrome_trace(self.path)
        flops = sum(e.flops or 0 for e in self._prof.key_averages())
        with open(stem + FLOPS_SUFFIX, "w") as f:
            json.dump({"flops": flops}, f)
        return self.path


def start_trace(logdir: str) -> Capture:
    os.makedirs(logdir, exist_ok=True)
    return Capture(logdir)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Record the enclosed region into a trace under ``logdir`` (yields
    the directory).  When the region raises, stopping is best-effort and
    the region's exception is the one that propagates; on the clean path a
    failure to stop or write the trace raises (a profile that silently
    wrote nothing would mislead)."""
    cap = start_trace(logdir)
    try:
        yield logdir
    except BaseException:
        try:
            cap.stop()
        except Exception:
            log.warning("profiler stop failed while unwinding a crashed "
                        "region (the trace under %s may be missing)",
                        logdir, exc_info=True)
        raise
    else:
        cap.stop()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_steps(logdir: str, step_fn: Callable, *args: Any,
                  warmup: int = 2, steps: int = 5) -> Tuple[Any, str]:
    """Trace ``steps`` calls of ``step_fn(*args)`` after ``warmup``
    untraced ones (the first calls' allocations and algorithm searches
    stay out of the trace).  A step that returns ``(state, metrics)`` with
    a state of its first argument's type carries the state into the next
    call.  Returns (last output, the trace directory)."""
    out = None
    current = tuple(args)

    def once(cur):
        result = step_fn(*cur)
        if (isinstance(result, tuple) and len(result) == 2 and cur
                and type(result[0]) is type(cur[0])):
            return result, (result[0], *cur[1:])
        return result, cur

    for _ in range(warmup):
        out, current = once(current)
    _sync()
    with profile_trace(logdir):
        for _ in range(steps):
            out, current = once(current)
        _sync()
    return out, logdir


def _newest(logdir: str):
    """The newest trace's events and the FLOPs counted beside it (None
    where none were)."""
    traces = glob.glob(os.path.join(logdir, "*" + TRACE_SUFFIX))
    if not traces:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {logdir}")
    newest = max(traces, key=lambda p: (os.path.getmtime(p), p))
    with open(newest) as f:
        events = json.load(f).get("traceEvents", [])
    sidecar = newest[:-len(TRACE_SUFFIX)] + FLOPS_SUFFIX
    flops = None
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            flops = json.load(f).get("flops") or None
    return events, flops


def _outermost(events):
    """The events not nested in another of the same thread (host ops call
    ops: only the outermost count toward time)."""
    out, end = [], {}
    for e in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"),
                                           e["ts"], -e.get("dur", 0))):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= end.get(key, float("-inf")):
            out.append(e)
            end[key] = e["ts"] + e.get("dur", 0)
    return out


def trace_summary(logdir: str, *, cpu_events: bool = False) -> Dict:
    """Summarise the newest trace under ``logdir``: device milliseconds
    and kernel counts by class (``CLASSES``: the port's flash kernels,
    conv, gemm, elementwise, other), their total, the TOP_KERNELS names
    with the most time, and, where the profiler counted FLOPs
    (``with_flops``: the forward ops it knows, matrix products and
    convolutions, not their backward), the FLOPs and their rate over the
    device time.  Raises ``ValueError`` when the trace holds no device
    kernels (a CPU-only run), as the reference does, unless
    ``cpu_events``: then the outermost host ops stand in for kernels."""
    events, flops = _newest(logdir)
    events = [e for e in events if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset")]
    source = "device"
    if not device:
        if not cpu_events:
            raise ValueError(
                f"trace under {logdir} has no device kernels (no card in "
                "the run?); refusing to report a zero profile")
        device = _outermost([e for e in events if e.get("cat") == "cpu_op"])
        source = "cpu"
    classes = {c: {"ms": 0.0, "count": 0} for c in CLASSES}
    by_name: Dict[str, list] = {}
    for e in device:
        name = e.get("name", "")
        ms = float(e.get("dur", 0.0)) / 1e3
        row = classes[kernel_class(name)]
        row["ms"] += ms
        row["count"] += 1
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += ms
        acc[1] += 1
    total_ms = sum(r["ms"] for r in classes.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    out = {"source": source, "total_ms": total_ms, "kernels": len(device),
           "classes": classes, "flops": flops,
           "top": [{"name": n[:120], "ms": ms, "count": c}
                   for n, (ms, c) in top]}
    if flops and total_ms:
        out["tflops_per_s"] = flops / (total_ms * 1e-3) / 1e12
    return out
