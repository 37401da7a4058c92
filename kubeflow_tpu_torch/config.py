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
