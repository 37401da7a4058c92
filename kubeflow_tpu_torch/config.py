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


# The checkpoint directory a job controller injects into a trainer's
# environment (the reference's ``parallel/envspec.py``
# ``ENV_KFT_CHECKPOINT_DIR``): ``train/run.py``'s ``--checkpoint-dir``
# defaults to it.
ENV_KFT_CHECKPOINT_DIR = "KFT_CHECKPOINT_DIR"

# The continuous-batching scheduler's knobs (``models/scheduler.py``):
# pool rows, cache positions per row (0: the model's max_seq_len), decode
# steps per dispatch, pipelined dispatch on or off.  ``KFT_SERVE_SCHEDULER``
# (``models/serve.py``) set to 0 pins an instrumented service to the
# lock-serialized path.
SERVE_SLOTS = ("KFT_SERVE_SLOTS", 8)
SERVE_SLOT_LEN = ("KFT_SERVE_SLOT_LEN", 0)
SERVE_DECODE_QUANTUM = ("KFT_SERVE_DECODE_QUANTUM", 8)
SERVE_PIPELINE = ("KFT_SERVE_PIPELINE", True)
SERVE_SCHEDULER = ("KFT_SERVE_SCHEDULER", True)


def env_int_strict(name: str, default: int,
                   validate: Callable[[int], Any]) -> int:
    """An integer knob that refuses a bad value: unset resolves to
    ``default``; an unparseable value, or one ``validate`` (value ->
    error message or None) rejects, raises ``ValueError`` naming the
    knob, where ``env_int`` would quietly serve the default."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        value = int(raw.strip())
    except ValueError:
        raise ValueError(f"{name}={raw!r}: not a valid int") from None
    problem = validate(value)
    if problem:
        raise ValueError(f"{name}={raw!r}: {problem}")
    return value


# The paged engine's knobs (``models/paged.py``), with the reference's
# defaults, ranges and messages (``kubeflow_tpu/models/paged.py``).
# ``KFT_SERVE_PAGED`` set to 0 pins an instrumented service to the
# fixed-slot pool.  The integer knobs are strict (``env_int_strict``).
SERVE_PAGED = ("KFT_SERVE_PAGED", True)
SERVE_PAGE_LEN = ("KFT_SERVE_PAGE_LEN", 64,
                  lambda v: None if 1 <= v <= 4096
                  else "must be in [1, 4096]")
# 0: the fixed pool's capacity (slots x slot_len / page_len) + 1.
SERVE_PAGES = ("KFT_SERVE_PAGES", 0,
               lambda v: None if v >= 0 else "must be >= 0")
# 0: the whole prompt suffix in one pass.
SERVE_PREFILL_CHUNK = ("KFT_SERVE_PREFILL_CHUNK", 512,
                       lambda v: None if v >= 0 else "must be >= 0")
SERVE_SPEC_TOKENS = ("KFT_SERVE_SPEC_TOKENS", 4,
                     lambda v: None if 0 <= v <= 64
                     else "must be in [0, 64]")
SERVE_PREFIX_CACHE = ("KFT_SERVE_PREFIX_CACHE", True)
