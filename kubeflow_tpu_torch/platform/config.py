"""The platform's environment knobs: the readers of the port's copy of
``kubeflow_tpu/platform/config.py`` (the reference's GetEnvDefault
pattern, culling_controller.go:385-391 / notebook_controller.go:203,427,
489,503).  An unset or unparseable value resolves to the default.  The
reference's knob registry serves its /debug/knobs page, which the port
does not have yet.  The compute side's readers stay in
``kubeflow_tpu_torch/config.py``.

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
