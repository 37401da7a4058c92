"""Wrappers of the port's CUDA kernels, each beside its plain version.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
the plain version only for CPU tensors.  ``launch_counts`` reads every
wrapper's launch count; a run that must show it went through the kernels
sets them to 0 with ``reset_launch_counts`` first.
"""
from __future__ import annotations

from kubeflow_tpu_torch.ops.cuda import flash_attention, flash_decode, rms_norm

# Kernel name -> wrapper (each carries an integer ``launches``).
WRAPPERS = {
    "rms_norm": rms_norm.rms_norm,
    "rms_norm_bwd": rms_norm.rms_norm_bwd,
    "flash_attention_fwd": flash_attention.flash_attention,
    "flash_attention_fwd_lse": flash_attention.flash_attention_fwd_lse,
    "flash_attention_dq": flash_attention.flash_attention_dq,
    "flash_attention_dkv": flash_attention.flash_attention_dkv,
    "flash_decode": flash_decode.flash_decode,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
