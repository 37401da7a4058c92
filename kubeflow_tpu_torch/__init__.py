"""kubeflow_tpu_torch — the in-notebook compute stack in PyTorch for NVIDIA Hopper.

A port of the compute stack of the JAX package (``kubeflow_tpu/``),
grown slice by slice beside it; the JAX package stays the reference.
This package imports ``torch`` and the standard library only: no JAX,
and nothing of the JAX package (it keeps its own copies of what it
needs).

Every TPU kernel on a ported path has a hand-written CUDA counterpart in
``ops/csrc`` (built by ``ops/_build.py``); plain tensor code is PyTorch.
Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise instead of falling back to the CPU.  Tests pass
``device="cpu"``, where every kernel wrapper uses its plain version.
Importing the package root loads no torch, so the control plane
(``platform/``) starts without it.
"""
from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises ``RuntimeError`` (never a silent move to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev
