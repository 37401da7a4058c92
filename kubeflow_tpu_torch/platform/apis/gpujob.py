"""GPUJob CRD schema: defaulting, validation, well-known labels.

The port's copy of ``kubeflow_tpu/platform/apis/tpujob.py`` with a
``spec.gpu`` block in place of ``spec.tpu``: a gang-scheduled,
multi-slice batch job over the same vocabulary a Notebook's ``spec.gpu``
uses.

    apiVersion: kubeflow.org/v1alpha1
    kind: GPUJob
    spec:
      gpu:
        accelerator: h100-80gb  # key into platform.gpu.ACCELERATORS
        gpus: 16                # GPUs a slice; one full host otherwise
        slices: 2               # slices joined over the data-center
                                # network (default 1)
        minSlices: 1            # elastic floor: may run at fewer slices
                                # (default = slices: the gang is rigid)
      template:
        spec: {containers: [...]}   # worker PodSpec; containers[0] trains
      restartPolicy: OnFailure  # or Never
      backoffLimit: 3           # max whole-gang restarts before Failed
      priority: 100             # queue rank; higher preempts lower (>= 1)
      checkpointDir: /ckpt/...  # injected as KFT_CHECKPOINT_DIR; a
                                # restarted gang resumes from its latest step
    status:
      phase: Pending|Queued|Running|Restarting|Preempting|Succeeded|Failed
      restarts: int             # FAILURE restarts consumed (backoffLimit)
      generation: int           # gang generations (restarts + resizes +
                                # preemption re-admissions)
      allocatedSlices: int      # granted gang width while holding GPUs
      reason: str               # structured queue reason (REASON column)
      queuedAt: float           # epoch secs of the last Queued transition
      slices: [{slice, ready, total}]
      conditions: [...]

Gang semantics are all-or-nothing: one worker pod failing tears down and
recreates EVERY slice's StatefulSet.  ``spec.gpu`` is REQUIRED — a
GPUJob without GPUs is a plain Job and does not belong to this
controller.
"""
from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.platform.gpu import GpuSliceSpec, slice_spec
from kubeflow_tpu_torch.platform.k8s.types import Resource, deep_get

GROUP = "kubeflow.org"
VERSION = "v1alpha1"

LABEL_GPUJOB_NAME = "gpujob-name"
# Every GPUJob worker pod carries this label so admins can target the whole
# training fleet with one PodDefault selector.
LABEL_GPUJOB_WORKER = "gpujob-worker"
# Gang generation: stamped on each generation's StatefulSets and pods; a
# restart bumps it, so stragglers of a torn-down generation are identifiable
# (and never read as the new gang's members).
LABEL_GENERATION = "gpujob-generation"

RESTART_POLICIES = ("OnFailure", "Never")
DEFAULT_BACKOFF_LIMIT = 3
# Queue rank when spec.priority is unset; explicit priorities must be >= 1
# (validated at admission — a non-positive priority parks Degraded).
DEFAULT_PRIORITY = 100

PHASE_PENDING = "Pending"
PHASE_QUEUED = "Queued"
PHASE_RUNNING = "Running"
PHASE_RESTARTING = "Restarting"
PHASE_PREEMPTING = "Preempting"
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"
TERMINAL_PHASES = (PHASE_SUCCEEDED, PHASE_FAILED)
# Phases in which a job HOLDS its allocated GPUs (the jobqueue ledger
# charges status.allocatedSlices against quota + pool capacity);
# Queued/terminal jobs hold nothing.
HOLDING_PHASES = (PHASE_PENDING, PHASE_RUNNING, PHASE_RESTARTING,
                  PHASE_PREEMPTING)


class ValidationError(ValueError):
    pass


def _gpu(job: Resource) -> dict:
    return deep_get(job, "spec", "gpu", default={}) or {}


def validate(job: Resource) -> None:
    name = deep_get(job, "metadata", "name", default="")
    if not name or len(name) > 52:
        # 52 = 63-char DNS label minus room for "-s<i>-<ordinal>" suffixes.
        raise ValidationError("metadata.name required, max 52 chars")
    containers = deep_get(job, "spec", "template", "spec", "containers")
    if not containers:
        raise ValidationError("spec.template.spec.containers must be non-empty")
    if not (containers[0] or {}).get("command"):
        # The worker runs containers[0]'s command under the launcher, one
        # process a GPU (gpu/pods.py job_worker_container).
        raise ValidationError(
            "spec.template.spec.containers[0].command is required: the "
            "launcher runs it once for each GPU of the host")
    gpu = deep_get(job, "spec", "gpu")
    if not gpu or not gpu.get("accelerator"):
        raise ValidationError("spec.gpu.accelerator is required for a GPUJob")
    try:
        slice_spec(gpu.get("accelerator", ""), gpu.get("gpus"),
                   gpu.get("slices"))
    except ValueError as e:
        raise ValidationError(str(e)) from None
    policy = deep_get(job, "spec", "restartPolicy")
    if policy is not None and policy not in RESTART_POLICIES:
        raise ValidationError(
            f"spec.restartPolicy must be one of {RESTART_POLICIES}, "
            f"got {policy!r}")
    backoff = deep_get(job, "spec", "backoffLimit")
    if backoff is not None and (not isinstance(backoff, int)
                                or isinstance(backoff, bool) or backoff < 0):
        raise ValidationError("spec.backoffLimit must be a non-negative integer")
    priority = deep_get(job, "spec", "priority")
    if priority is not None and (not isinstance(priority, int)
                                 or isinstance(priority, bool)
                                 or priority < 1):
        raise ValidationError(
            f"spec.priority must be a positive integer, got {priority!r}")
    min_slices = gpu.get("minSlices")
    if min_slices is not None:
        if (not isinstance(min_slices, int) or isinstance(min_slices, bool)
                or min_slices < 1):
            raise ValidationError(
                f"spec.gpu.minSlices must be a positive integer, "
                f"got {min_slices!r}")
        slices = int(gpu.get("slices") or 1)
        if slices < min_slices:
            raise ValidationError(
                f"spec.gpu.slices ({slices}) must be >= spec.gpu.minSlices "
                f"({min_slices})")


def gpu_slice(job: Resource) -> GpuSliceSpec:
    gpu = _gpu(job)
    return slice_spec(gpu.get("accelerator", ""), gpu.get("gpus"),
                      gpu.get("slices"))


def gpu_slice_or_none(job: Resource) -> Optional[GpuSliceSpec]:
    """``gpu_slice`` for aggregation paths: a stored-invalid spec (possible
    via kubectl — its own reconcile parks it Degraded) yields None instead
    of crashing the caller."""
    try:
        return gpu_slice(job)
    except ValueError:
        return None


def restart_policy(job: Resource) -> str:
    return deep_get(job, "spec", "restartPolicy", default="OnFailure") \
        or "OnFailure"


def backoff_limit(job: Resource) -> int:
    limit = deep_get(job, "spec", "backoffLimit")
    return DEFAULT_BACKOFF_LIMIT if limit is None else int(limit)


def checkpoint_dir(job: Resource) -> Optional[str]:
    return deep_get(job, "spec", "checkpointDir") or None


def priority_of(job: Resource) -> int:
    p = deep_get(job, "spec", "priority")
    return DEFAULT_PRIORITY if p is None else int(p)


def min_slices_of(job: Resource) -> int:
    """Elastic floor: the fewest slices the gang may run at.  Defaults to
    ``spec.gpu.slices`` — a job that never declared elasticity is rigid."""
    gpu = _gpu(job)
    m = gpu.get("minSlices")
    if m is None:
        return int(gpu.get("slices") or 1)
    return int(m)


def phase_of(job: Resource) -> str:
    return deep_get(job, "status", "phase", default=PHASE_PENDING) \
        or PHASE_PENDING


def restarts_of(job: Resource) -> int:
    return int(deep_get(job, "status", "restarts", default=0) or 0)


def generation_of(job: Resource) -> int:
    """Gang generation (the label stamped on every generation's
    StatefulSets/pods).  Distinct from ``restarts``: failure restarts
    bump BOTH, but a preemption re-admission or an elastic resize bumps
    only the generation — they are not failures and must never eat into
    ``backoffLimit``."""
    gen = deep_get(job, "status", "generation")
    if gen is None:
        return restarts_of(job)
    return int(gen)


def allocated_slices(job: Resource) -> Optional[int]:
    """Granted gang width while the job holds GPUs (set at admission,
    cleared when a preemption completes); None = not admitted."""
    alloc = deep_get(job, "status", "allocatedSlices")
    return None if alloc is None else int(alloc)


def queued_at(job: Resource) -> Optional[float]:
    t = deep_get(job, "status", "queuedAt")
    return None if t is None else float(t)


def crd_manifest() -> Resource:
    """The CustomResourceDefinition to install."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "gpujobs.kubeflow.org"},
        "spec": {
            "group": GROUP,
            "names": {"kind": "GPUJob", "plural": "gpujobs",
                      "singular": "gpujob"},
            "scope": "Namespaced",
            "versions": [{
                "name": VERSION,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                # `kubectl get gpujobs` shows the queue state at a glance
                # (PHASE/PRIORITY/SLICES/REASON/AGE).
                "additionalPrinterColumns": [
                    {"name": "Phase", "type": "string",
                     "jsonPath": ".status.phase"},
                    {"name": "Priority", "type": "integer",
                     "jsonPath": ".spec.priority"},
                    {"name": "Slices", "type": "integer",
                     "jsonPath": ".status.allocatedSlices"},
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
                            "required": ["gpu", "template"],
                            "properties": {
                                "gpu": {
                                    "type": "object",
                                    "required": ["accelerator"],
                                    "properties": {
                                        "accelerator": {"type": "string"},
                                        "gpus": {"type": "integer",
                                                 "minimum": 1},
                                        "slices": {"type": "integer",
                                                   "minimum": 1},
                                        "minSlices": {"type": "integer",
                                                      "minimum": 1},
                                    },
                                },
                                "template": {
                                    "type": "object",
                                    "x-kubernetes-preserve-unknown-fields":
                                        True,
                                },
                                "restartPolicy": {
                                    "type": "string",
                                    "enum": list(RESTART_POLICIES),
                                },
                                "backoffLimit": {"type": "integer",
                                                 "minimum": 0},
                                "priority": {"type": "integer",
                                             "minimum": 1},
                                "checkpointDir": {"type": "string"},
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
