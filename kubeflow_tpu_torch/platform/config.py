"""The platform's environment knobs: the readers of the port's copy of
``kubeflow_tpu/platform/config.py`` (the reference's GetEnvDefault
pattern, culling_controller.go:385-391 / notebook_controller.go:203,427,
489,503).  An unset or unparseable value resolves to the default.  The
reference's knob registry serves its /debug/knobs page, which the port
does not have yet.  The compute side's readers stay in
``kubeflow_tpu_torch/config.py``.
"""
from __future__ import annotations

import os
from typing import Any, Callable

from kubeflow_tpu_torch.config import parse_bool


def _read(name: str, default: Any, parser: Callable[[str], Any]) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return parser(raw)
    except (TypeError, ValueError):
        return default


def env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def env_bool(name: str, default: bool = False) -> bool:
    return _read(name, default, parse_bool)


def env_float(name: str, default: float) -> float:
    return _read(name, default, float)


def env_int(name: str, default: int) -> int:
    return _read(name, default, int)
