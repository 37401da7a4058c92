"""The platform on NVIDIA GPUs: the port's copy of the notebook control
plane, the culler, the job path and the controller runtime that drives
them of ``kubeflow_tpu/platform/``, and the GPU seams their pods are
made of.

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
* ``controllers/culling.py``: ``CullingReconciler``, which probes an
  idle notebook's kernels and stops it to free its GPUs;
* ``controllers/gpujob.py``: ``GPUJobReconciler``, a GPUJob into a gang
  of StatefulSets behind a headless Service, admitted, preempted and
  resumed by the queue ledger (``runtime/jobqueue.py`` ``JobQueue``);
* ``webhook/``: the PodDefault merge and its AdmissionReview with a
  JSON patch;
* ``runtime/``: the reconciler's contract, the work queue,
  ``Controller`` and ``Manager`` with leader election or shards, the
  shard leases with their fencing (``sharding.py``: ``ShardCoordinator``,
  ``FencedClient``, ``ShardFilter``, ``FencingError``, ``shard_of``),
  the informer caches, child writes, events, the fan-out pool, the job
  queue and the metrics;
* ``testing/fake.py``: ``FakeKube``, the in-memory API server with quota
  admission, the cascade on delete and the server-side shard filter;
  ``testing/jobsim.py``: ``GpuJobGangSim``, the kubelet and the training
  processes of a gang; ``testing/chaos.py``: ``ChaosKube``, seeded fault
  injection with a wire log; ``testing/shardfleet.py``:
  ``ShardedFleet``, replicas over one API server, killed, paused or
  churned;
* ``config.py``: the platform's env knobs.

Standard library only (with the port's ``parallel/envspec.py`` and
``telemetry/``).  Drive it on the CPU: one leader-elected ``Manager``
runs the notebook, culling and job controllers from watches::

    kube = FakeKube(); kube.add_namespace("kubeflow")
    kube.add_namespace("ns")
    mgr = Manager(kube, leader_election=True)
    nb = mgr.add(notebook_controller(kube, use_istio=False))
    mgr.add(culling_controller(kube, notebook_informer=nb.informers[NOTEBOOK]))
    mgr.add(gpujob_controller(kube))
    mgr.start()
    kube.create(notebook)            # spec.gpu {accelerator, gpus}
    kube.list(STATEFULSET, "ns")     # the children, once reconciled
    mgr.stop()

Sharded HA: replicas each run a ``Manager`` over their own shard
coordinator and fenced client; a killed replica's shards are absorbed
within one lease TTL::

    coord = ShardCoordinator(kube, identity="r0")
    client = FencedClient(kube, coord)
    mgr = Manager(client, shards=coord)
    mgr.add(notebook_controller(client, shards=coord))
    mgr.start()

A reconciler also runs bare on a client::

    NotebookReconciler(kube, use_istio=True).reconcile(Request("ns", name))

and a GPUJob's pods (``spec.gpu {accelerator, gpus, slices,
minSlices}``) run under the kubelet's stand-in::

    sim = GpuJobGangSim(kube, "ns", work=train)   # pods, then train()
    GPUJobReconciler(kube).reconcile(Request("ns", job))
"""

from kubeflow_tpu_torch.platform.apis.poddefault import gpu_pod_default
from kubeflow_tpu_torch.platform.controllers.culling import (
    CullingReconciler,
    default_prober,
)
from kubeflow_tpu_torch.platform.controllers.culling import (
    make_controller as culling_controller,
)
from kubeflow_tpu_torch.platform.controllers.gpujob import GPUJobReconciler
from kubeflow_tpu_torch.platform.controllers.gpujob import (
    make_controller as gpujob_controller,
)
from kubeflow_tpu_torch.platform.controllers.notebook import NotebookReconciler
from kubeflow_tpu_torch.platform.controllers.notebook import (
    make_controller as notebook_controller,
)
from kubeflow_tpu_torch.platform.runtime.controller import (
    Controller,
    Manager,
    Request,
)
from kubeflow_tpu_torch.platform.runtime.informer import Informer
from kubeflow_tpu_torch.platform.runtime.jobqueue import JobQueue
from kubeflow_tpu_torch.platform.runtime.leader import LeaderElector
from kubeflow_tpu_torch.platform.runtime.sharding import (
    FencedClient,
    FencingError,
    ShardCoordinator,
    ShardFilter,
    shard_of,
)
from kubeflow_tpu_torch.platform.testing.fake import FakeKube
from kubeflow_tpu_torch.platform.testing.jobsim import GpuJobGangSim
from kubeflow_tpu_torch.platform.testing.shardfleet import ShardedFleet
from kubeflow_tpu_torch.platform.webhook.mutate import mutate_admission_review

__all__ = ["Controller", "CullingReconciler", "FakeKube", "FencedClient",
           "FencingError", "GPUJobReconciler", "GpuJobGangSim", "Informer",
           "JobQueue", "LeaderElector", "Manager", "NotebookReconciler",
           "Request", "ShardCoordinator", "ShardFilter", "ShardedFleet",
           "culling_controller", "default_prober", "gpu_pod_default",
           "gpujob_controller", "mutate_admission_review",
           "notebook_controller", "shard_of"]
