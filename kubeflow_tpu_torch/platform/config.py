"""The platform's environment knobs: the readers of the port's copy of
``kubeflow_tpu/platform/config.py`` (the reference's GetEnvDefault
pattern, culling_controller.go:385-391 / notebook_controller.go:203,427,
489,503), and its knob registry.  Every knob resolves through
``knob(name, default, parser)``, which reads the environment and records
the knob (name, default, parser, doc, secrecy, check) in ``KNOBS``, so
``effective()`` can list the live surface: the controllers' health port
serves it at ``/debug/knobs`` and each incident bundle carries it.  An
unset or unparseable value resolves to the default; a knob with a
``validate`` check raises ``ValueError`` on a bad value instead.  The
``env``/``env_bool``/``env_float``/``env_int`` readers are thin
wrappers over ``knob``.  It is the port's one registry: the model side
(``models/``, ``telemetry/``, ``train/``) reads its knobs here too, so
they show in ``effective()`` as the reference's do.  A raw
``os.environ`` read anywhere else in the port is a kftlint finding
(R005, ``analysis/rules.py``).

The controller runtime's knobs, the reference's names and defaults,
each read through these helpers where it is used:

* ``CONTROLLER_MAX_RETRIES`` (15), ``CONTROLLER_STUCK_SECONDS`` (300),
  ``CONTROLLER_WORKERS`` (4) and ``CONTROLLER_WORKERS_<NAME>``:
  ``runtime/controller.py``;
* ``TRACE_SLOW_RECONCILE_SECONDS`` (1), ``TRACE_DISABLE`` and
  ``TRACE_BUFFER_SIZE`` (64): ``runtime/trace.py``;
* ``CULL_IDLE_TIME`` (1440 minutes), ``IDLENESS_CHECK_PERIOD`` (1
  minute), ``CULL_PROBE_TIMEOUT_SECONDS`` (10),
  ``CULL_PROBE_BUDGET_SECONDS`` (0, no budget), ``CLUSTER_DOMAIN``
  (``cluster.local``) and ``DEV`` (probe through a local kubectl
  proxy): ``controllers/culling.py``;
* ``CONTROLLER_SHARD_LEASE_SECONDS`` (15), ``CONTROLLER_SHARD_RENEW_SECONDS``
  (5) and ``CONTROLLER_SHARD_RETRY_SECONDS`` (2), the shard leases'
  defaults: ``runtime/sharding.py``;
* ``KF_SHARD_SERVER_FILTER`` (on; ``0`` turns it off, any other value
  leaves it on): the server-side shard filter of the informers' streams,
  ``runtime/controller.py``;
* ``K8S_CLIENT_TIMEOUT`` (30), ``K8S_CLIENT_TIMEOUT_CONNECT`` (5),
  ``K8S_CLIENT_RETRIES`` (3), ``K8S_CLIENT_RETRY_BASE`` (0.1),
  ``K8S_CLIENT_RETRY_CAP`` (5), ``K8S_CLIENT_CB_THRESHOLD`` (5),
  ``K8S_CLIENT_CB_COOLDOWN`` (10), ``K8S_CLIENT_QPS`` (50; 0 disables the
  limit), ``K8S_CLIENT_BURST`` (100) and ``K8S_CLIENT_POOL_SIZE`` (32),
  and the config's ``KUBERNETES_SERVICE_HOST``/``_PORT`` and
  ``KUBECONFIG``: ``k8s/client.py``;
* ``KF_NATIVE`` (``1``; ``0`` disables the native engine, any other
  value keeps it on): ``native.py``; ``KF_WIRE_CODEC`` (``auto``, or
  ``native`` or ``python``; any other value keeps ``auto``):
  ``k8s/codec.py``.

The model side's knobs, the reference's names, defaults and checks:

* ``KFT_SERVE_SLOTS`` (8), ``KFT_SERVE_SLOT_LEN`` (0: the model's
  ``max_seq_len``), ``KFT_SERVE_DECODE_QUANTUM`` (8) and
  ``KFT_SERVE_PIPELINE`` (on): ``models/scheduler.py``;
* ``KFT_SERVE_PAGE_LEN`` (64, in [1, 4096]), ``KFT_SERVE_PAGES`` (0: the
  fixed pool's capacity + 1), ``KFT_SERVE_PREFILL_CHUNK`` (512) and
  ``KFT_SERVE_SPEC_TOKENS`` (4, in [0, 64]), each strict, and
  ``KFT_SERVE_PREFIX_CACHE`` (on): ``models/paged.py``;
* ``KFT_SERVE_SCHEDULER`` and ``KFT_SERVE_PAGED`` (on),
  ``KFT_SERVE_REVISION`` (0) and ``DEBUG_TRACES`` (on):
  ``models/serve.py``; ``SERVE_SLOW_REQUEST_SECONDS`` (30) and
  ``SERVE_TRACE_BUFFER_SIZE`` (64): ``telemetry/serve.py``;
* ``TRAIN_SLOW_STEP_SECONDS`` (10), ``TRAIN_TRACE_DISABLE``,
  ``TRAIN_TRACE_BUFFER_SIZE`` (64) and ``ATTENTION_HBM_BUDGET_FRACTION``
  (0.5): ``telemetry/compute.py``; ``KFT_CHECKPOINT_DIR``:
  ``train/run.py``; ``KFT_SLOW_STEP_PROFILE_DIR``: ``train/loop.py``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, NamedTuple

__all__ = ["KNOBS", "Knob", "effective", "env", "env_bool", "env_float",
           "env_int", "knob", "parse_bool"]

_SECRET_MARKERS = (
    "TOKEN", "SECRET", "PASSWORD", "PASSWD", "CREDENTIAL", "API_KEY",
    "APIKEY", "PRIVATE",
)


class Knob(NamedTuple):
    name: str
    default: Any
    parser: Callable[[str], Any]
    doc: str
    secret: bool
    # value -> an error message, or None for a good value.  A knob with
    # a check refuses a bad value where it is read (ValueError) instead
    # of falling back to the default.
    validate: Callable[[Any], Any] = None


# name -> Knob; the first registration wins (the table documents a knob,
# each read still returns with its own default).
KNOBS: Dict[str, Knob] = {}
_lock = threading.Lock()


def parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


def knob(name: str, default: Any = None, parser: Callable[[str], Any] = str,
         *, doc: str = "", secret: bool = None,
         validate: Callable[[Any], Any] = None) -> Any:
    """The env value of ``name`` parsed, or ``default`` when it is unset
    or (without ``validate``) does not parse; the knob is recorded in
    ``KNOBS``.  ``secret`` defaults to a sniff of the name (TOKEN,
    SECRET, ...) and redacts the value in ``effective()``."""
    if secret is None:
        secret = any(m in name.upper() for m in _SECRET_MARKERS)
    with _lock:
        if name not in KNOBS:
            KNOBS[name] = Knob(name, default, parser, doc, secret, validate)
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = parser(raw)
    except (TypeError, ValueError):
        if validate is not None:
            raise ValueError(
                f"{name}={raw!r}: not a valid "
                f"{getattr(parser, '__name__', 'value')}") from None
        return default
    if validate is not None:
        problem = validate(value)
        if problem:
            raise ValueError(f"{name}={raw!r}: {problem}")
    return value


def _plain(value: Any) -> Any:
    return (value if isinstance(value, (str, int, float, bool, type(None)))
            else str(value))


def effective(*, redact: bool = True) -> Dict[str, dict]:
    """Every registered knob with its value resolved now: ``{name:
    {"value", "default", "source"[, "doc"]}}``.  ``source`` is
    ``default``, ``env``, ``env-unparseable`` (the value did not parse,
    so the default runs) or ``env-invalid`` (its check refused it); a
    secret set from the environment shows as ``<redacted>``."""
    out: Dict[str, dict] = {}
    with _lock:
        items = sorted(KNOBS.items())
    for name, k in items:
        raw = os.environ.get(name)
        if raw is None:
            value, source = k.default, "default"
        else:
            try:
                value, source = k.parser(raw), "env"
            except (TypeError, ValueError):
                value, source = k.default, "env-unparseable"
            if source == "env" and k.validate is not None \
                    and k.validate(value):
                value, source = k.default, "env-invalid"
        if redact and k.secret and source == "env":
            value = "<redacted>"
        entry = {"value": _plain(value), "default": _plain(k.default),
                 "source": source}
        if k.doc:
            entry["doc"] = k.doc
        out[name] = entry
    return out


def env(name: str, default: str = "") -> str:
    return knob(name, default, str)


def env_bool(name: str, default: bool = False) -> bool:
    return knob(name, default, parse_bool)


def env_float(name: str, default: float) -> float:
    return knob(name, default, float)


def env_int(name: str, default: int) -> int:
    return knob(name, default, int)
