"""The platform on NVIDIA GPUs: the port's copy of the notebook control
plane and the job path of ``kubeflow_tpu/platform/``, and the GPU seams
their pods are made of.

* ``gpu/``: the accelerator table and slice math (``topology.py``) and
  the pod pieces of a notebook, a job's worker and a serving replica
  (``pods.py``);
* ``k8s/``: unstructured objects and the GVK table (``types.py``), the
  API's errors (``errors.py``) and the quota math with its admission
  check (``quota.py``);
* ``apis/``: the Notebook, GPUJob and InferenceService CRDs with
  ``spec.gpu``, and the PodDefault CRD;
* ``controllers/notebook.py``: ``NotebookReconciler``, a Notebook into
  its StatefulSets, Services, PDB and VirtualService;
* ``controllers/gpujob.py``: ``GPUJobReconciler``, a GPUJob into a gang
  of StatefulSets behind a headless Service, admitted, preempted and
  resumed by the queue ledger (``runtime/jobqueue.py`` ``JobQueue``);
* ``webhook/``: the PodDefault merge and its AdmissionReview with a
  JSON patch;
* ``runtime/``: the reconciler's contract, child writes, events, the
  fan-out pool, the job queue and the metrics of both paths;
* ``testing/fake.py``: ``FakeKube``, the in-memory API server with quota
  admission and the cascade on delete; ``testing/jobsim.py``:
  ``GpuJobGangSim``, the kubelet and the training processes of a gang;
* ``config.py``: the platform's env knobs.

Standard library only (with the port's ``parallel/envspec.py`` and
``telemetry/``).  Drive it on the CPU::

    kube = FakeKube(); kube.add_namespace("ns")
    kube.create(notebook)            # spec.gpu {accelerator, gpus}
    NotebookReconciler(kube, use_istio=True).reconcile(Request("ns", name))
    kube.list(STATEFULSET, "ns")     # the children

and a GPUJob (``spec.gpu {accelerator, gpus, slices, minSlices}``)::

    sim = GpuJobGangSim(kube, "ns", work=train)   # pods, then train()
    GPUJobReconciler(kube).reconcile(Request("ns", job))
"""

from kubeflow_tpu_torch.platform.apis.poddefault import gpu_pod_default
from kubeflow_tpu_torch.platform.controllers.gpujob import GPUJobReconciler
from kubeflow_tpu_torch.platform.controllers.notebook import NotebookReconciler
from kubeflow_tpu_torch.platform.runtime.controller import Request
from kubeflow_tpu_torch.platform.runtime.jobqueue import JobQueue
from kubeflow_tpu_torch.platform.testing.fake import FakeKube
from kubeflow_tpu_torch.platform.testing.jobsim import GpuJobGangSim
from kubeflow_tpu_torch.platform.webhook.mutate import mutate_admission_review

__all__ = ["FakeKube", "GPUJobReconciler", "GpuJobGangSim", "JobQueue",
           "NotebookReconciler", "Request", "gpu_pod_default",
           "mutate_admission_review"]
