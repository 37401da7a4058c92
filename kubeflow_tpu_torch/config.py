"""Environment readers the port uses (its own copy of the few
``kubeflow_tpu/platform/config.py`` helpers it needs): an unset or
unparseable value resolves to the default."""
from __future__ import annotations

import os
from typing import Any, Callable


def _env(name: str, default: Any, parser: Callable[[str], Any]) -> Any:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return parser(raw.strip())
    except ValueError:
        return default


def parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


def env_bool(name: str, default: bool = False) -> bool:
    return _env(name, default, parse_bool)


def env_int(name: str, default: int) -> int:
    return _env(name, default, int)


def env_float(name: str, default: float) -> float:
    return _env(name, default, float)
