"""Notebook status as shown in the UI table.

Derivation order mirrors the reference (reference
jupyter/backend/apps/common/status.py:9-54 + events fallback :148-182):
stopped annotation → terminating → ready → waiting-with-reason, where the
reason falls back to recent Warning events (scheduling failures on GPU
capacity, "Insufficient nvidia.com/gpu", surface here as "Waiting for GPU
capacity").  The port's copy of ``kubeflow_tpu/platform/apps/jupyter/
status.py``.
"""
from __future__ import annotations

from typing import List, Optional

from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.k8s.types import Resource, deep_get


def process_status(notebook: Resource, events: Optional[List[Resource]] = None) -> dict:
    if deep_get(notebook, "metadata", "deletionTimestamp"):
        return _status("terminating", "Deleting this notebook server")
    if nbapi.is_stopped(notebook):
        return _status("stopped", "No Pods are currently running for this server")

    replicas = deep_get(notebook, "status", "replicas", default=None)
    ready = deep_get(notebook, "status", "readyReplicas", default=0)
    if replicas and ready == replicas:
        return _status("running", "Running")

    # Degraded condition (invalid spec) wins over generic waiting.
    for cond in deep_get(notebook, "status", "conditions", default=[]) or []:
        if cond.get("type") == "Degraded" and cond.get("status") == "True":
            return _status("warning", cond.get("message", "Invalid notebook spec"))

    state = deep_get(notebook, "status", "containerState", default={}) or {}
    if "waiting" in state:
        reason = state["waiting"].get("reason", "Waiting")
        message = state["waiting"].get("message", "")
        severity = "warning" if reason in ("CrashLoopBackOff", "ImagePullBackOff",
                                           "ErrImagePull") else "waiting"
        return _status(severity, f"{reason}: {message}".rstrip(": "))

    for ev in reversed(events or []):
        if ev.get("type") == "Warning":
            message = ev.get("message", "")
            if "Insufficient nvidia.com/gpu" in message:
                return _status(
                    "waiting",
                    f"Waiting for GPU capacity: {message}",
                )
            return _status("warning", message)
    return _status("waiting", "Starting the notebook server")


def _status(phase: str, message: str) -> dict:
    return {"phase": phase, "message": message, "state": ""}
