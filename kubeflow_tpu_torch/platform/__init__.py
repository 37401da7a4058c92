"""The platform on NVIDIA GPUs: the port's copy of the notebook control
plane of ``kubeflow_tpu/platform/``, and the GPU seams its pods are made
of.

* ``gpu/``: the accelerator table and slice math (``topology.py``) and
  the pod pieces of a notebook, a job's worker and a serving replica
  (``pods.py``);
* ``k8s/``: unstructured objects and the GVK table (``types.py``), the
  API's errors (``errors.py``) and the quota math with its admission
  check (``quota.py``);
* ``apis/``: the Notebook CRD with ``spec.gpu`` and the PodDefault CRD;
* ``controllers/notebook.py``: ``NotebookReconciler``, a Notebook into
  its StatefulSets, Services, PDB and VirtualService;
* ``webhook/``: the PodDefault merge and its AdmissionReview with a
  JSON patch;
* ``runtime/``: the reconciler's contract, child writes, events, the
  fan-out pool and the notebook path's metrics;
* ``testing/fake.py``: ``FakeKube``, the in-memory API server with quota
  admission and the cascade on delete;
* ``config.py``: the platform's env knobs.

Standard library only (with the port's ``parallel/envspec.py`` and
``telemetry/``).  Drive it on the CPU::

    kube = FakeKube(); kube.add_namespace("ns")
    kube.create(notebook)            # spec.gpu {accelerator, gpus}
    NotebookReconciler(kube, use_istio=True).reconcile(Request("ns", name))
    kube.list(STATEFULSET, "ns")     # the children
"""

from kubeflow_tpu_torch.platform.apis.poddefault import gpu_pod_default
from kubeflow_tpu_torch.platform.controllers.notebook import NotebookReconciler
from kubeflow_tpu_torch.platform.runtime.controller import Request
from kubeflow_tpu_torch.platform.testing.fake import FakeKube
from kubeflow_tpu_torch.platform.webhook.mutate import mutate_admission_review

__all__ = ["FakeKube", "NotebookReconciler", "Request", "gpu_pod_default",
           "mutate_admission_review"]
