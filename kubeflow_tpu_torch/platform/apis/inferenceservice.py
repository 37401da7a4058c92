"""InferenceService CRD schema: defaulting, validation, well-known labels.

The port's copy of ``kubeflow_tpu/platform/apis/inferenceservice.py``
with a ``spec.gpu`` block in place of ``spec.tpu``.  An InferenceService
is N replicas of the ``models/serve.py`` generation server, each replica
one host's GPUs:

    apiVersion: kubeflow.org/v1alpha1
    kind: InferenceService
    spec:
      model: llama_1b4          # key into the model zoo registry
      checkpointDir: /ckpt/...  # optional; restored by the replica through
                                # train/checkpoint.py (params only)
      quantize: int8            # optional weight-only int8 serving
      mesh: "tp=4"              # optional per-replica --mesh shape
      gpu:
        accelerator: h100-80gb  # key into platform.gpu.ACCELERATORS
        gpus: 4                 # GPUs PER REPLICA, at most one host's
      port: 8080                # replica HTTP port (/v1/generate, /metrics)
      replicas: {min: 0, max: 4, initial: 2}
      scale: {queueDepthTarget, ttftP99TargetSeconds, slotOccupancyTarget,
              idleSeconds, cooldownSeconds}
    status:
      phase: Pending|Ready|Rolling|Idle|Waking|Degraded
      replicas: int           # current TARGET width (the ledger charge)
      revision: int           # revision currently taking traffic
      targetRevision: int     # revision being rolled in
      ...

Replica GPUs are charged into the GPUJob admission ledger
(``runtime/jobqueue.py``) from WATCH STATE — ``gpus_of`` parses
``status.replicas`` x one replica's GPUs — so serving and training share
one quota truth.  The serving controller
(``controllers/inferenceservice.py``) reconciles it, its autoscaler
(``runtime/autoscale.py``) sizes it and the activator
(``platform/activator.py``) wakes it.

A replica's Deployment is ``gpu/pods.py`` ``serving_deployment`` over
these fields (``model_of``, ``port_of``, ``checkpoint_dir_of``,
``spec.quantize``, ``spec.mesh``, ``spec.maxSeqLen``, ``spec.image``,
the labels below).  It differs from the reference's Deployment where the
card does: a ``spec.mesh`` replica's command runs under the launcher,
one process a GPU, and the container carries ``KFT_GPUS_PER_HOST``.
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional, Tuple

from kubeflow_tpu_torch.platform.gpu import GpuSliceSpec, slice_spec
# The replica pods' labels (the Service selects on both; the revision
# label is how a rollout flips traffic) and port are the Deployment's own.
from kubeflow_tpu_torch.platform.gpu.pods import (  # noqa: F401
    DEFAULT_SERVE_PORT as DEFAULT_PORT,
    LABEL_REVISION,
    LABEL_SERVICE_NAME,
)
from kubeflow_tpu_torch.platform.k8s.types import Resource, deep_get

GROUP = "kubeflow.org"
VERSION = "v1alpha1"

# Cold-start wake contract: the request frontend (activator) stamps this
# annotation with an epoch timestamp when a request arrives for a
# scaled-to-zero service.
ANNOTATION_WAKE = "inferenceservices.kubeflow.org/wake-at"
# Sim/test endpoint override: when present on a replica pod, the controller
# scrapes/probes this base URL instead of http://<podIP>:<port>.
ANNOTATION_ENDPOINT = "inferenceservices.kubeflow.org/endpoint"

PHASE_PENDING = "Pending"
PHASE_READY = "Ready"
PHASE_ROLLING = "Rolling"
PHASE_IDLE = "Idle"
PHASE_WAKING = "Waking"

DEFAULT_QUEUE_DEPTH_TARGET = 4.0
DEFAULT_SLOT_OCCUPANCY_TARGET = 0.8
DEFAULT_IDLE_SECONDS = 300.0
DEFAULT_COOLDOWN_SECONDS = 30.0

REASON_QUOTA_CLAMPED = "QuotaClamped"


class ValidationError(ValueError):
    pass


def validate(svc: Resource) -> None:
    name = deep_get(svc, "metadata", "name", default="")
    if not name or len(name) > 48:
        # 48 = 63-char DNS label minus room for "-v<rev>" Deployment names
        # and the pods' "-<hash>" suffixes.
        raise ValidationError("metadata.name required, max 48 chars")
    if not deep_get(svc, "spec", "model"):
        raise ValidationError("spec.model is required")
    gpu = deep_get(svc, "spec", "gpu")
    if not gpu or not gpu.get("accelerator"):
        raise ValidationError(
            "spec.gpu.accelerator is required for an InferenceService")
    if gpu.get("slices") not in (None, 1):
        raise ValidationError(
            "spec.gpu.slices is not an InferenceService field: each "
            "replica serves exactly one slice; scale replicas instead")
    try:
        spec = slice_spec(gpu.get("accelerator", ""), gpu.get("gpus"), 1)
    except ValueError as e:
        raise ValidationError(str(e)) from None
    if spec.num_hosts != 1:
        # A replica is ONE server process over its own host's GPUs
        # (--mesh); more hosts are a GPUJob-shaped workload, not a
        # Deployment replica.
        raise ValidationError(
            f"spec.gpu.gpus {spec.gpus} spans {spec.num_hosts} hosts; "
            "serving replicas must be single-host — scale spec.replicas "
            "instead")
    lo, hi = replica_bounds(svc)
    if lo < 0:
        raise ValidationError("spec.replicas.min must be >= 0")
    if hi < max(lo, 1):
        raise ValidationError(
            f"spec.replicas.max ({hi}) must be >= max(min, 1)")
    init = deep_get(svc, "spec", "replicas", "initial")
    if init is not None and not lo <= int(init) <= hi:
        raise ValidationError(
            f"spec.replicas.initial ({init}) must be within [min, max]")
    quant = deep_get(svc, "spec", "quantize")
    if quant is not None and quant != "int8":
        raise ValidationError(f"spec.quantize must be 'int8', got {quant!r}")
    port = deep_get(svc, "spec", "port")
    if port is not None and (not isinstance(port, int)
                             or isinstance(port, bool)
                             or not 1 <= port <= 65535):
        raise ValidationError(f"spec.port must be a port number, got {port!r}")
    for key, floor in (("queueDepthTarget", 0.0),
                       ("ttftP99TargetSeconds", 0.0),
                       ("slotOccupancyTarget", 0.0),
                       ("idleSeconds", 0.0), ("cooldownSeconds", 0.0)):
        val = deep_get(svc, "spec", "scale", key)
        if val is None:
            continue
        if isinstance(val, bool) or not isinstance(val, (int, float)) \
                or float(val) <= floor:
            raise ValidationError(
                f"spec.scale.{key} must be a positive number, got {val!r}")


def model_of(svc: Resource) -> str:
    return deep_get(svc, "spec", "model", default="") or ""


def checkpoint_dir_of(svc: Resource) -> Optional[str]:
    return deep_get(svc, "spec", "checkpointDir") or None


def port_of(svc: Resource) -> int:
    return int(deep_get(svc, "spec", "port", default=DEFAULT_PORT)
               or DEFAULT_PORT)


def gpu_slice(svc: Resource) -> GpuSliceSpec:
    """The ONE slice each replica serves (spec.gpu.slices is rejected at
    validation — replicas are the scale axis)."""
    gpu = deep_get(svc, "spec", "gpu", default={}) or {}
    return slice_spec(gpu.get("accelerator", ""), gpu.get("gpus"), 1)


def gpu_slice_or_none(svc: Resource) -> Optional[GpuSliceSpec]:
    try:
        return gpu_slice(svc)
    except ValueError:
        return None


def replica_bounds(svc: Resource) -> Tuple[int, int]:
    reps = deep_get(svc, "spec", "replicas", default={}) or {}
    lo = int(reps.get("min", 1) if reps.get("min") is not None else 1)
    hi = int(reps.get("max", max(lo, 1))
             if reps.get("max") is not None else max(lo, 1))
    return lo, hi


def initial_replicas(svc: Resource) -> int:
    """First-reconcile target: spec.replicas.initial, else max(min, 1) —
    a brand-new service always warms at least one replica so the first
    request is never a cold start."""
    init = deep_get(svc, "spec", "replicas", "initial")
    lo, hi = replica_bounds(svc)
    if init is None:
        return max(lo, 1)
    return min(max(int(init), lo), hi)


def phase_of(svc: Resource) -> str:
    return deep_get(svc, "status", "phase", default=PHASE_PENDING) \
        or PHASE_PENDING


def target_replicas_of(svc: Resource) -> Optional[int]:
    """The current TARGET width (status.replicas) — what the ledger
    charges; None until the first reconcile commits one."""
    reps = deep_get(svc, "status", "replicas")
    return None if reps is None else int(reps)


def revision_of(svc: Resource) -> int:
    return int(deep_get(svc, "status", "revision", default=0) or 0)


def target_revision_of(svc: Resource) -> int:
    rev = deep_get(svc, "status", "targetRevision")
    return revision_of(svc) if rev is None else int(rev)


def gpus_of(svc: Resource) -> float:
    """GPUs this service commits in its namespace, as the jobqueue
    ledger accounts them: target replicas x one replica's GPUs — PLUS
    the warming revision's width while a rollout is in flight (both
    revision Deployments run side by side until the flip, and a gang
    must never be promised the overlap).  Parsed purely from watch state
    (spec + status) so every ledger rebuild computes the same charge."""
    spec = gpu_slice_or_none(svc)
    if spec is None:
        return 0.0
    reps = target_replicas_of(svc)
    if reps is None:
        reps = initial_replicas(svc)
    total = max(reps, 0)
    if target_revision_of(svc) != revision_of(svc):
        total += max(reps, 1)  # the target revision warms at this width
    return float(total) * spec.gpus


def wake_requested_at(svc: Resource) -> Optional[float]:
    raw = deep_get(svc, "metadata", "annotations", ANNOTATION_WAKE)
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def revision_hash(svc: Resource) -> str:
    """Content hash over every pod-spec-affecting field: a change here is
    a new revision; a change anywhere else (replica bounds, scale
    targets) never restarts pods."""
    material = {
        "model": model_of(svc),
        "checkpointDir": checkpoint_dir_of(svc),
        "quantize": deep_get(svc, "spec", "quantize"),
        "mesh": deep_get(svc, "spec", "mesh"),
        "image": deep_get(svc, "spec", "image"),
        "port": port_of(svc),
        "gpu": deep_get(svc, "spec", "gpu", default={}) or {},
        "maxSeqLen": deep_get(svc, "spec", "maxSeqLen"),
    }
    return hashlib.sha256(
        json.dumps(material, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]


def crd_manifest() -> Resource:
    """The CustomResourceDefinition to install."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "inferenceservices.kubeflow.org"},
        "spec": {
            "group": GROUP,
            "names": {"kind": "InferenceService",
                      "plural": "inferenceservices",
                      "singular": "inferenceservice"},
            "scope": "Namespaced",
            "versions": [{
                "name": VERSION,
                "served": True,
                "storage": True,
                "subresources": {
                    "status": {},
                    # The scale subresource: kubectl scale / HPA-shaped
                    # tooling reads and writes the SAME replica fields the
                    # autoscaler drives.
                    "scale": {
                        "specReplicasPath": ".spec.replicas.initial",
                        "statusReplicasPath": ".status.replicas",
                        "labelSelectorPath": ".status.selector",
                    },
                },
                "additionalPrinterColumns": [
                    {"name": "Phase", "type": "string",
                     "jsonPath": ".status.phase"},
                    {"name": "Model", "type": "string",
                     "jsonPath": ".spec.model"},
                    {"name": "Replicas", "type": "integer",
                     "jsonPath": ".status.replicas"},
                    {"name": "Ready", "type": "integer",
                     "jsonPath": ".status.readyReplicas"},
                    {"name": "Revision", "type": "integer",
                     "jsonPath": ".status.revision"},
                    {"name": "Reason", "type": "string",
                     "jsonPath": ".status.reason"},
                    {"name": "Age", "type": "date",
                     "jsonPath": ".metadata.creationTimestamp"},
                ],
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "spec": {
                            "type": "object",
                            "required": ["model", "gpu"],
                            "properties": {
                                "model": {"type": "string"},
                                "checkpointDir": {"type": "string"},
                                "quantize": {"type": "string",
                                             "enum": ["int8"]},
                                "mesh": {"type": "string"},
                                "image": {"type": "string"},
                                "maxSeqLen": {"type": "integer",
                                              "minimum": 1},
                                "port": {"type": "integer",
                                         "minimum": 1, "maximum": 65535},
                                "gpu": {
                                    "type": "object",
                                    "required": ["accelerator"],
                                    "properties": {
                                        "accelerator": {"type": "string"},
                                        "gpus": {"type": "integer",
                                                 "minimum": 1},
                                    },
                                },
                                "replicas": {
                                    "type": "object",
                                    "properties": {
                                        "min": {"type": "integer",
                                                "minimum": 0},
                                        "max": {"type": "integer",
                                                "minimum": 1},
                                        "initial": {"type": "integer",
                                                    "minimum": 0},
                                    },
                                },
                                "scale": {
                                    "type": "object",
                                    "properties": {
                                        "queueDepthTarget":
                                            {"type": "number"},
                                        "ttftP99TargetSeconds":
                                            {"type": "number"},
                                        "slotOccupancyTarget":
                                            {"type": "number"},
                                        "idleSeconds": {"type": "number"},
                                        "cooldownSeconds":
                                            {"type": "number"},
                                    },
                                },
                            },
                        },
                        "status": {
                            "type": "object",
                            "x-kubernetes-preserve-unknown-fields": True,
                        },
                    },
                }},
            }],
        },
    }
