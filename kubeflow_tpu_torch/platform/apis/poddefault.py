"""PodDefault CRD schema + the GPU PodDefault factory.

The port's copy of ``kubeflow_tpu/platform/apis/poddefault.py`` with
``gpu_pod_default`` in place of ``tpu_pod_default``.  Field set mirrors
the reference CRD (reference poddefault_types.go:27-112): selector, env,
envFrom, volumes, volumeMounts, initContainers, sidecars, tolerations,
labels, annotations, command, args, serviceAccountName,
automountServiceAccountToken, imagePullSecrets, desc.
"""
from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.parallel.envspec import ENV_KFT_GPUS_PER_HOST
from kubeflow_tpu_torch.platform.gpu import slice_spec
from kubeflow_tpu_torch.platform.k8s.types import Resource


def gpu_pod_default(namespace: str, accelerator: str,
                    gpus: Optional[int] = None) -> Resource:
    """A PodDefault that injects the GPU runtime's env into any pod that
    opts in via the ``gpu-<accelerator>`` label (the spawner's
    configurations checklist sets exactly that label): the GPUs of a
    host in ``KFT_GPUS_PER_HOST`` (what the launcher runs one process
    for) and a memory-backed ``/dev/shm``, which NCCL and the data
    loader's worker processes share tensors through."""
    s = slice_spec(accelerator, gpus)
    label = f"gpu-{s.accelerator.name}"
    return {
        "apiVersion": "kubeflow.org/v1alpha1",
        "kind": "PodDefault",
        "metadata": {"name": label, "namespace": namespace},
        "spec": {
            "desc": f"GPU {s.accelerator.name} runtime "
                    f"({s.gpus} GPUs, {s.gpus_per_pod} a host)",
            "selector": {"matchLabels": {label: "true"}},
            "env": [
                {"name": ENV_KFT_GPUS_PER_HOST, "value": str(s.gpus_per_pod)},
            ],
            "volumes": [{
                "name": "gpu-shm",
                "emptyDir": {"medium": "Memory", "sizeLimit": "16Gi"},
            }],
            "volumeMounts": [{"name": "gpu-shm", "mountPath": "/dev/shm"}],
        },
    }


def crd_manifest() -> Resource:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": "poddefaults.kubeflow.org"},
        "spec": {
            "group": "kubeflow.org",
            "names": {"kind": "PodDefault", "plural": "poddefaults",
                      "singular": "poddefault"},
            "scope": "Namespaced",
            "versions": [{
                "name": "v1alpha1",
                "served": True,
                "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "spec": {
                            "type": "object",
                            "x-kubernetes-preserve-unknown-fields": True,
                            "required": ["selector"],
                        },
                    },
                }},
            }],
        },
    }
