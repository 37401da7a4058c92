"""Build and load the port's CUDA kernels: ``nvcc`` by hand, ``ctypes`` to bind.

Every ``ops/csrc/*.cu`` is compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, ``build/kernels/libkft_kernels.so``
at the root of the checkout.  No source includes PyTorch's headers, so a
build takes seconds rather than minutes.  The sources are compiled in
parallel (one ``nvcc`` per file, all started together), then linked.

The library is rebuilt when the hash of the sources and flags changes,
and loaded once per process.  Each C entry point takes its pointers and
the CUDA stream as ``void*`` and returns ``cudaGetLastError()``;
``check`` raises when that is nonzero.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libkft_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point in ops/csrc: (argtypes), restype int.
SIGNATURES = {
    # x, scale, y, rows, d, eps, x_is_bf16, scale_is_bf16, stream
    "kft_rms_norm": (_P, _P, _P, _I, _I, _F, _I, _I, _P),
    # x, scale, g, dx, dscale, workspace, rows, d, eps, x_is_bf16,
    # scale_is_bf16, max_blocks, stream
    "kft_rms_norm_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P),
    # q, k, v, seg_or_null, o, lse_or_null, b, sq, sk, hq, hk, d, causal,
    # scale, stream
    "kft_flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _F, _P),
    # q, k, v, o, dout, lse, glse_or_null, seg_or_null, dq, delta, b, sq, sk,
    # hq, hk, d, causal, scale, stream
    "kft_flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, dout, lse, delta, seg_or_null, dk, dv, b, sq, sk, hq, hk, d,
    # causal, scale, stream
    "kft_flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, bias, o, b, S, h, kv_h, d, scale, stream
    "kft_flash_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None
last_build_log = ""


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def compile_commands(out_dir: Path, nvcc: str) -> list:
    """One ``nvcc -c`` per source, then the link into the shared library."""
    objs = [out_dir / (src.stem + ".o") for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)] for src, obj in zip(sources(), objs)]
    cmds.append([nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME),
                 *map(str, objs)])
    return cmds


def build(out_dir: Path = BUILD_DIR, *, force: bool = False,
          verbose: bool = False) -> Path:
    """Compile the kernels unless the library for this source hash exists
    (``force`` compiles regardless).  Returns the library's path.
    ``verbose`` adds ``-Xptxas -v``; the compiler's output (registers,
    shared memory, spills) is kept in ``last_build_log``."""
    global last_build_seconds, last_build_log
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    stamp = out_dir / (LIB_NAME + ".hash")
    digest = source_hash()
    if not force and lib.exists() and stamp.exists() \
            and stamp.read_text() == digest:
        return lib
    t0 = time.perf_counter()
    cmds = compile_commands(out_dir, nvcc_path())
    if verbose:
        cmds = [c[:1] + ["-Xptxas", "-v"] + c[1:] for c in cmds[:-1]] + cmds[-1:]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds[:-1]]
    failed, logs = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    link = subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    stamp.write_text(digest)
    last_build_log = "".join(logs)
    last_build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.kft_error_string.argtypes = [ctypes.c_int]
            lib.kft_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and ``synchronize`` would not report it)."""
    if err != 0:
        msg = library().kft_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
