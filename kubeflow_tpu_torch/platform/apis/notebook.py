"""Notebook CRD schema: defaulting, validation, well-known annotations.

The port's copy of ``kubeflow_tpu/platform/apis/notebook.py`` with a
``spec.gpu`` block in place of the reference's ``spec.tpu``.  The shape
mirrors the reference CRD (reference notebook_types.go:27-88: a PodSpec
template + status mirroring pod state) with the accelerator request
first-class instead of buried in the template:

    apiVersion: kubeflow.org/v1beta1
    kind: Notebook
    spec:
      template:
        spec: {containers: [...], volumes: [...]}     # corev1.PodSpec shape
      gpu:
        accelerator: h100-80gb  # key into platform.gpu.ACCELERATORS
        gpus: 8                 # optional; one full host otherwise
        slices: 1               # optional
    status:
      conditions: [...]         # mirrored from worker-0 pod
      readyReplicas: int
      containerState: {...}
"""
from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.platform.gpu import (
    RESOURCE_GPU,
    GpuSliceSpec,
    slice_spec,
)
from kubeflow_tpu_torch.platform.k8s.types import Resource, deep_get

# Annotation contract shared with the reference ecosystem (set by the web
# app's stop action and the culler; reference culling_controller.go:50).
STOP_ANNOTATION = "kubeflow-resource-stopped"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
# Istio routing annotations (reference notebook_controller.go:471-565).
ANNOTATION_REWRITE_URI = "notebooks.kubeflow.org/http-rewrite-uri"
ANNOTATION_HEADERS_REQUEST_SET = "notebooks.kubeflow.org/http-headers-request-set"

DEFAULT_PORT = 8888
LABEL_NOTEBOOK_NAME = "notebook-name"

GROUP = "kubeflow.org"
HUB_VERSION = "v1beta1"
# Served versions, oldest first.  v1beta1 is the hub/storage version (the
# reference does the same, notebook-controller/api/v1/notebook_conversion.go:25-60,
# where v1 and v1alpha1 are spokes converting through the v1beta1 hub).
VERSIONS = ("v1alpha1", "v1", "v1beta1")
# Legacy (v1alpha1/v1) representation of the GPU request: the GPU limit
# on the main container plus annotations, instead of the first-class
# spec.gpu block the hub version has.  The names are the reference's
# with "gpu" for "tpu"; the GPU count stands where the TPU topology does.
GPU_RESOURCE = RESOURCE_GPU
ANNOTATION_GPU_ACCELERATOR = "notebooks.kubeflow.org/gpu-accelerator"
ANNOTATION_GPU_COUNT = "notebooks.kubeflow.org/gpu-count"
ANNOTATION_GPU_SLICES = "notebooks.kubeflow.org/gpu-slices"
# The usage key GPU requests count under in a ResourceQuota.
GPU_REQUESTS = f"requests.{RESOURCE_GPU}"


class ValidationError(ValueError):
    pass


def validate(notebook: Resource) -> None:
    containers = deep_get(notebook, "spec", "template", "spec", "containers")
    if not containers:
        raise ValidationError("spec.template.spec.containers must be non-empty")
    name = deep_get(notebook, "metadata", "name", default="")
    if not name or len(name) > 52:
        # 52 = 63-char DNS label minus room for "-<ordinal>" pod suffixes.
        raise ValidationError("metadata.name required, max 52 chars")
    gpu = notebook.get("spec", {}).get("gpu")
    if gpu:
        try:
            slice_spec(
                gpu.get("accelerator", ""), gpu.get("gpus"), gpu.get("slices")
            )
        except ValueError as e:
            raise ValidationError(str(e)) from None


def gpu_slice(notebook: Resource) -> Optional[GpuSliceSpec]:
    gpu = deep_get(notebook, "spec", "gpu")
    if not gpu or not gpu.get("accelerator"):
        return None
    return slice_spec(gpu["accelerator"], gpu.get("gpus"), gpu.get("slices"))


def gpu_slice_or_none(notebook: Resource) -> Optional[GpuSliceSpec]:
    """`gpu_slice` for aggregation paths: a stored-invalid spec.gpu (possible
    via kubectl or legacy annotation lift — its own reconcile parks it
    Degraded) yields None instead of crashing the caller."""
    try:
        return gpu_slice(notebook)
    except ValueError:
        return None


def is_stopped(notebook: Resource) -> bool:
    return STOP_ANNOTATION in (
        deep_get(notebook, "metadata", "annotations", default={}) or {}
    )


def declared_gpus(notebook: Resource) -> float:
    """GPUs a notebook CR commits, whether or not its pods exist yet:
    spec.gpu is authoritative (aggregate over slices); a CR without it
    (kubectl-created) falls back to its raw template GPU limits."""
    from kubeflow_tpu_torch.platform.k8s import quota as quota_mod

    s = gpu_slice_or_none(notebook)
    if s is not None:
        return float(s.total_gpus)
    tmpl = deep_get(notebook, "spec", "template", "spec", default={}) or {}
    try:
        usage = quota_mod.pod_quota_usage({"spec": tmpl})
    except ValueError:
        return 0.0
    return usage.get(GPU_REQUESTS, 0.0)


def running_notebook_pod_usage(client, ns: str, running: list, *,
                               lister=None) -> dict:
    """Aggregate quota footprint of live pods that belong to RUNNING
    (non-stopped) notebooks — exactly the slice of a quota's status.used
    that the declared CR totals already cover (quota.effective_used).  A
    just-stopped notebook's still-terminating pods are NOT included: their
    CR has left the declared tally, so they must keep counting as live
    usage or a respawn passes pre-flight and strands at pod admission.
    Shared by the spawn pre-flight, the picker and the dashboard card —
    ONE implementation so the surfaces cannot drift apart.

    ``lister`` (gvk, ns) -> objects lets callers substitute an informer
    cache read (frozen views) for the live LIST; every access below is
    read-only, so both shapes work."""
    from kubeflow_tpu_torch.platform.k8s import quota as quota_mod
    from kubeflow_tpu_torch.platform.k8s.types import POD, name_of

    if lister is None:
        lister = client.list
    running_names = {name_of(nb) for nb in running}
    usage: dict = {}
    for pod in lister(POD, ns):
        labels = deep_get(pod, "metadata", "labels", default={}) or {}
        phase = deep_get(pod, "status", "phase", default="")
        if labels.get(LABEL_NOTEBOOK_NAME) in running_names and \
                phase not in ("Succeeded", "Failed"):
            try:
                usage = quota_mod.add_usage(
                    usage, quota_mod.pod_quota_usage(pod))
            except ValueError:
                continue
    return usage


def namespace_gpu_budget(client, ns: str, *, lister=None) -> Optional[dict]:
    """Per-namespace GPU budget {hard, used, remaining} from the tightest
    ResourceQuota, under the platform's commitment accounting
    (quota.effective_used): GPUs declared by running notebook CRs (pods
    or not) PLUS live usage by non-notebook pods — what quota admission
    will actually do.  None when no quota constrains `nvidia.com/gpu` in
    the namespace.

    ``lister`` (gvk, ns) -> objects substitutes informer-cache reads
    (frozen views) for live LISTs; everything here is read-only.
    """
    from kubeflow_tpu_torch.platform.k8s import quota as quota_mod
    from kubeflow_tpu_torch.platform.k8s.types import RESOURCEQUOTA
    from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK as NOTEBOOK_GVK

    if lister is None:
        lister = client.list
    quotas = lister(RESOURCEQUOTA, ns)
    if not quotas:
        return None
    running = [nb for nb in lister(NOTEBOOK_GVK, ns)
               if not is_stopped(nb)]
    declared = sum(declared_gpus(nb) for nb in running)
    pod_used = running_notebook_pod_usage(
        client, ns, running, lister=lister).get(GPU_REQUESTS, 0.0)
    return quota_mod.gpu_remaining(
        quotas, declared=declared, workload_pod_used=pod_used
    )


def notebook_port(notebook: Resource) -> int:
    ports = deep_get(
        notebook, "spec", "template", "spec", "containers", default=[{}]
    )[0].get("ports") or []
    for p in ports:
        if p.get("containerPort"):
            return int(p["containerPort"])
    return DEFAULT_PORT


def nb_prefix(namespace: str, name: str) -> str:
    return f"/notebook/{namespace}/{name}"


def service_port_name(name: str) -> str:
    """The per-notebook Service port name: http- prefix drives Istio
    protocol selection (reference notebook_controller.go:438-465), capped at
    the k8s 15-char port-name limit.  Shared by the Service generator and
    the DEV-mode kubectl-proxy probe URL, which must agree."""
    return f"http-{name}"[:15]


# -- multi-version conversion (hub/spoke) ------------------------------------
#
# v1beta1 (hub):   spec.gpu: {accelerator, gpus, slices}
# v1, v1alpha1:    GPU limits on containers[0] + gpu annotations; v1alpha1
#                  additionally has no containerState in status (mirrors the
#                  reference's v1alpha1→v1beta1 status widening).


class ConversionError(ValueError):
    pass


def version_of(notebook: Resource) -> str:
    api_version = notebook.get("apiVersion", "")
    group, _, version = api_version.partition("/")
    if group != GROUP or version not in VERSIONS:
        raise ConversionError(f"not a served Notebook apiVersion: {api_version!r}")
    return version


def _positive_int(value) -> Optional[int]:
    """An annotation's integer when it is a sane count (>= 1), else None:
    annotations are not schema-validated, and only a sane value may
    become stored hub spec."""
    try:
        n = int(value)
    except (TypeError, ValueError):
        return None
    return n if n >= 1 else None


def _to_hub(notebook: Resource) -> Resource:
    """Spoke → hub: lift annotation/limit GPU shape into spec.gpu."""
    import copy

    version = version_of(notebook)
    nb = copy.deepcopy(notebook)
    nb["apiVersion"] = f"{GROUP}/{HUB_VERSION}"
    if version == HUB_VERSION:
        return nb
    annotations = deep_get(nb, "metadata", "annotations", default={}) or {}
    accelerator = annotations.pop(ANNOTATION_GPU_ACCELERATOR, None)
    gpus = annotations.pop(ANNOTATION_GPU_COUNT, None)
    slices = annotations.pop(ANNOTATION_GPU_SLICES, None)
    containers = deep_get(nb, "spec", "template", "spec", "containers", default=[])
    # Only strip the GPU limit when the accelerator annotation identifies
    # the GPU model (the limit is then derivable from spec.gpu); a bare
    # nvidia.com/gpu limit with no annotation stays as-is in the template
    # rather than being dropped.
    if accelerator and containers:
        resources = containers[0].get("resources") or {}
        limits = resources.get("limits") or {}
        limits.pop(GPU_RESOURCE, None)
        if not limits:
            resources.pop("limits", None)
        if not resources:
            containers[0].pop("resources", None)
    # Partial annotations lift into a partial spec.gpu — the exact mirror of
    # _from_hub lowering every spec.gpu field into annotations, so
    # hub↔spoke conversion is lossless in both directions.
    count = _positive_int(gpus)
    if accelerator or count:
        gpu = {}
        if accelerator:
            gpu["accelerator"] = accelerator
        if count:
            gpu["gpus"] = count
        if slices and _positive_int(slices):
            # Anything but a sane value lifts as single-slice rather than
            # minting a spec every consumer rejects.
            gpu["slices"] = _positive_int(slices)
        nb.setdefault("spec", {})["gpu"] = gpu
    if annotations == {}:
        deep_get(nb, "metadata", default={}).pop("annotations", None)
    return nb


def _from_hub(notebook: Resource, version: str) -> Resource:
    """Hub → spoke: lower spec.gpu into GPU limits + annotations."""
    import copy

    if version not in VERSIONS:
        raise ConversionError(f"unknown Notebook version {version!r}")
    nb = copy.deepcopy(notebook)
    nb["apiVersion"] = f"{GROUP}/{version}"
    if version == HUB_VERSION:
        return nb
    gpu = (nb.get("spec") or {}).pop("gpu", None)
    if gpu and (gpu.get("accelerator") or gpu.get("gpus")):
        # Every spec.gpu field lowers into an annotation so hub→spoke→hub
        # round-trips losslessly even for partial (count-only) specs; the
        # GPU-limit lift additionally needs the accelerator to be known.
        annotations = nb.setdefault("metadata", {}).setdefault("annotations", {})
        if gpu.get("accelerator"):
            annotations[ANNOTATION_GPU_ACCELERATOR] = gpu["accelerator"]
        if gpu.get("gpus"):
            annotations[ANNOTATION_GPU_COUNT] = str(gpu["gpus"])
        if gpu.get("slices"):
            annotations[ANNOTATION_GPU_SLICES] = str(gpu["slices"])
        spec = None
        if gpu.get("accelerator"):
            try:
                spec = slice_spec(gpu["accelerator"], gpu.get("gpus"))
            except ValueError:
                spec = None
        containers = deep_get(nb, "spec", "template", "spec", "containers", default=[])
        if spec and containers:
            containers[0].setdefault("resources", {}).setdefault("limits", {})[
                GPU_RESOURCE
            ] = str(spec.gpus_per_pod)
    if version == "v1alpha1":
        (nb.get("status") or {}).pop("containerState", None)
    return nb


def convert(notebook: Resource, to_version: str) -> Resource:
    """Convert a Notebook between served versions through the v1beta1 hub."""
    return _from_hub(_to_hub(notebook), to_version)


def convert_review(review: Resource) -> Resource:
    """Handle an apiextensions ConversionReview (the CRD conversion webhook
    body): convert request.objects to request.desiredAPIVersion."""
    if not isinstance(review, dict):
        review = {}
    request = review.get("request") or {}
    if not isinstance(request, dict):
        request = {}
    uid = request.get("uid", "")
    desired = request.get("desiredAPIVersion", "")
    _, _, version = str(desired).partition("/")
    converted, result = [], {"status": "Success"}
    try:
        for obj in request.get("objects") or []:
            if not isinstance(obj, dict):
                raise ConversionError(f"object is not a Notebook: {obj!r:.80}")
            converted.append(convert(obj, version))
    except ConversionError as e:
        result = {"status": "Failed", "message": str(e)}
        converted = []
    return {
        "apiVersion": review.get("apiVersion", "apiextensions.k8s.io/v1"),
        "kind": "ConversionReview",
        "response": {"uid": uid, "result": result, "convertedObjects": converted},
    }


def crd_manifest() -> Resource:
    """The CustomResourceDefinition to install (structural schema kept
    permissive around the PodSpec, like the reference CRD)."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {
            "name": "notebooks.kubeflow.org",
            # cert-manager fills the conversion webhook caBundle in, same as
            # manifests/crds/notebook.yaml — keep the two in sync.
            "annotations": {
                "cert-manager.io/inject-ca-from": "kubeflow/kubeflow-tpu-webhook",
            },
        },
        "spec": {
            "group": "kubeflow.org",
            "names": {
                "kind": "Notebook",
                "plural": "notebooks",
                "singular": "notebook",
            },
            "scope": "Namespaced",
            "conversion": {
                "strategy": "Webhook",
                "webhook": {
                    "conversionReviewVersions": ["v1"],
                    "clientConfig": {
                        # Matches the deployed Service (manifests/webhook.yaml:
                        # kubeflow-tpu-webhook, port 443 → targetPort 4443).
                        "service": {
                            "name": "kubeflow-tpu-webhook",
                            "namespace": "kubeflow",
                            "path": "/convert",
                            "port": 443,
                        }
                    },
                },
            },
            "versions": [
                _crd_version(v, storage=(v == HUB_VERSION)) for v in VERSIONS
            ],
        },
    }


def _crd_version(name: str, *, storage: bool) -> dict:
    spec_properties: dict = {
        "template": {
            "type": "object",
            "x-kubernetes-preserve-unknown-fields": True,
        },
    }
    if name == HUB_VERSION:
        spec_properties["gpu"] = {
            "type": "object",
            "properties": {
                "accelerator": {"type": "string"},
                "gpus": {"type": "integer", "minimum": 1},
                "slices": {"type": "integer", "minimum": 1},
            },
        }
    return {
        "name": name,
        "served": True,
        "storage": storage,
        "subresources": {"status": {}},
        "schema": {
            "openAPIV3Schema": {
                "type": "object",
                "properties": {
                    "spec": {"type": "object", "properties": spec_properties},
                    "status": {
                        "type": "object",
                        "x-kubernetes-preserve-unknown-fields": True,
                    },
                },
            }
        },
    }
