"""ResourceQuota math for GPU workloads: quantities, a pod's usage, the
GPUs a namespace has left and a notebook's declared usage.

The port's copy of the helpers of the reference's
``kubeflow_tpu/platform/k8s/quota.py`` that the GPU budget needs
(``parse_quantity``, ``usage_key``, ``pod_quota_usage``, ``scale_usage``,
``add_usage``, ``effective_used``), with ``gpu_remaining`` in place of
``tpu_remaining`` and ``notebook_gpu_usage`` in place of the spawner's
``_notebook_usage`` (``kubeflow_tpu/platform/apps/jupyter/app.py:251-278``).
Every function is read-only over what it is handed and returns fresh
dicts.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

from kubeflow_tpu_torch.platform.gpu.topology import RESOURCE_GPU

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
           "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "k": 1e3, "M": 1e6,
            "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18}
# The usage key GPU requests count under (bare "nvidia.com/gpu" in a
# quota's spec.hard means the same, through ``usage_key``).
GPU_REQUESTS = f"requests.{RESOURCE_GPU}"
GPU_LIMITS = f"limits.{RESOURCE_GPU}"


def deep_get(obj, *path: str, default=None):
    """``obj[path[0]][path[1]]...``, or ``default`` where a step is
    missing or not a mapping."""
    cur = obj
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def parse_quantity(q) -> float:
    """Kubernetes quantity -> float in base units ("500m" -> 0.5, "2Gi" ->
    2**31).  Rejects non-finite values."""
    def finite(v: float) -> float:
        if not math.isfinite(v):
            raise ValueError(f"non-finite quantity {q!r}")
        return v

    if isinstance(q, (int, float)):
        return finite(float(q))
    s = str(q).strip()
    if not s:
        raise ValueError("empty quantity")
    for suffix, mult in _BINARY.items():
        if s.endswith(suffix):
            return finite(float(s[: -len(suffix)]) * mult)
    # "1e3" is a bare number in scientific notation, not an 'E' suffix.
    if s[-1] in _DECIMAL and not s[-1].isdigit():
        try:
            value = float(s[:-1])
        except ValueError:
            pass
        else:
            return finite(value * _DECIMAL[s[-1]])
    return finite(float(s))


def usage_key(hard_key: str) -> str:
    """A spec.hard key's usage key: bare resource names count requests
    ("nvidia.com/gpu" = "requests.nvidia.com/gpu"); "limits.*" and
    "pods" pass through."""
    if hard_key == "pods" or hard_key.startswith(("requests.", "limits.")):
        return hard_key
    return f"requests.{hard_key}"


def pod_quota_usage(pod) -> Dict[str, float]:
    """One pod's quota footprint: {"pods": 1, "requests.cpu": ..., ...}.
    A container's request defaults to its limit; init containers run one
    after another, so they count their largest, and the pod counts the
    larger of that and its main containers' sum."""
    def tally(containers, combine) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {"requests": {}, "limits": {}}
        for c in containers or []:
            res = c.get("resources") or {}
            requests, limits = (res.get("requests") or {},
                                res.get("limits") or {})
            for name, val in limits.items():
                out["limits"][name] = combine(
                    out["limits"].get(name, 0.0), parse_quantity(val))
            for name in set(requests) | set(limits):
                eff = requests.get(name, limits.get(name))
                out["requests"][name] = combine(
                    out["requests"].get(name, 0.0), parse_quantity(eff))
        return out

    main = tally(deep_get(pod, "spec", "containers", default=[]),
                 lambda a, b: a + b)
    init = tally(deep_get(pod, "spec", "initContainers", default=[]), max)
    usage: Dict[str, float] = {"pods": 1.0}
    for flavor in ("requests", "limits"):
        for name in set(main[flavor]) | set(init[flavor]):
            usage[f"{flavor}.{name}"] = max(main[flavor].get(name, 0.0),
                                            init[flavor].get(name, 0.0))
    return usage


def scale_usage(usage: Dict[str, float], n: int) -> Dict[str, float]:
    """The footprint of n identical pods (a slice's worth of workers)."""
    return {k: v * n for k, v in usage.items()}


def add_usage(*usages: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for usage in usages:
        for k, v in usage.items():
            out[k] = out.get(k, 0.0) + v
    return out


def effective_used(stored: float, declared: float,
                   workload_pod_used: float) -> float:
    """The commitment: workload CRs' declared usage in full, plus the live
    usage of other pods (``stored`` less what the CRs' own pods hold)."""
    return declared + max(0.0, stored - workload_pod_used)


def gpu_remaining(quotas: Iterable[dict], *, declared: float = 0.0,
                  workload_pod_used: float = 0.0
                  ) -> Optional[Dict[str, int]]:
    """The tightest nvidia.com/gpu budget across ``quotas``:
    {"hard": H, "used": U, "remaining": R}, or None when no quota
    constrains GPUs.  ``declared``/``workload_pod_used`` feed
    ``effective_used``; a malformed quantity skips its key."""
    best = None
    for q in quotas:
        hard = deep_get(q, "spec", "hard", default={}) or {}
        used_map = deep_get(q, "status", "used", default={}) or {}
        for key, hard_val in hard.items():
            if usage_key(key) != GPU_REQUESTS:
                continue
            try:
                h = parse_quantity(hard_val)
                u = parse_quantity(used_map.get(key, 0.0) or 0.0)
            except ValueError:
                continue
            u = effective_used(u, declared, workload_pod_used)
            r = max(0.0, h - u)
            if best is None or r < best["remaining"]:
                best = {"hard": int(h), "used": int(u), "remaining": int(r)}
    return best


def notebook_gpu_usage(template_pod: dict, spec) -> Dict[str, float]:
    """A notebook's declared footprint: its template pod's usage on every
    host of every slice, with the GPUs taken from ``spec`` (a
    ``GpuSliceSpec``, or None for a notebook without GPUs): any GPU limit
    the template carries is dropped, so none counts twice."""
    usage = pod_quota_usage(template_pod)
    if spec is None:
        return usage
    usage.pop(GPU_REQUESTS, None)
    usage.pop(GPU_LIMITS, None)
    usage = scale_usage(usage, spec.total_hosts)
    return add_usage(usage, {GPU_REQUESTS: float(spec.total_gpus),
                             GPU_LIMITS: float(spec.total_gpus)})
