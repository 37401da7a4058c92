"""The pod pieces of a GPU workload: a notebook's workers, a job's workers
and a serving replica.

Counterparts of what the reference's controllers write into a TPU pod:
the notebook's ``_inject_tpu``
(``kubeflow_tpu/platform/controllers/notebook.py:316-362``), the job's
``_inject_tpu`` and checkpoint env (``controllers/tpujob.py:662-668,
702-736``), and the serving Deployment
(``controllers/inferenceservice.py:516-590``, single host as
``apis/inferenceservice.py:118-125`` requires).  A GPU pod asks for
``nvidia.com/gpu``, selects nodes by ``nvidia.com/gpu.product`` and
carries ``envspec.gpu_bootstrap_env`` in place of the TPU block.  A
process that drives its host's GPUs (a job's trainer, a sharded server)
runs under ``parallel/launch.py``, one process a GPU; a notebook's
command runs as it is.
"""
from __future__ import annotations

from typing import List, Optional

from kubeflow_tpu_torch.parallel import envspec
from kubeflow_tpu_torch.parallel.launch import SHUTDOWN_TIMEOUT_S
from kubeflow_tpu_torch.platform.gpu.topology import GpuSliceSpec

LAUNCHER = ["python", "-m", "kubeflow_tpu_torch.parallel.launch", "--"]
SERVE_COMMAND = ["python", "-m", "kubeflow_tpu_torch.models.serve"]
DEFAULT_CLUSTER_DOMAIN = "cluster.local"
DEFAULT_SERVE_PORT = 8080
# The serving Deployment's labels (the reference's
# ``apis/inferenceservice.py:65-66``).
LABEL_SERVICE_NAME = "inferenceservice-name"
LABEL_REVISION = "inferenceservice-revision"
ENV_SERVE_REVISION = "KFT_SERVE_REVISION"
# Seconds a job's worker has from SIGTERM to its exit: the launcher's
# own wait for its processes to checkpoint (SHUTDOWN_TIMEOUT_S) and a
# margin to kill and reap what still runs after it.  It is the worker
# pod's terminationGracePeriodSeconds and the job controller's default
# preemption grace, so neither the kubelet nor the queue cuts a save
# the launcher still waits for.
JOB_KILL_MARGIN_S = 30
JOB_GRACE_S = SHUTDOWN_TIMEOUT_S + JOB_KILL_MARGIN_S


def slice_sts_name(name: str, slice_idx: int) -> str:
    """Slice 0's StatefulSet keeps the workload's name, so worker 0 of
    slice 0 (``<name>-0``) is the coordinator; later slices are
    ``<name>-s<i>``, both controllers' layout."""
    return name if slice_idx == 0 else f"{name}-s{slice_idx}"


def _worker_dns(name: str, ns: str, pod: str, cluster_domain: str) -> str:
    return f"{pod}.{name}-workers.{ns}.svc.{cluster_domain}"


def inject_gpu(pod_spec: dict, container: dict, *, ns: str, name: str,
               spec: GpuSliceSpec, slice_idx: int = 0,
               num_slices: Optional[int] = None,
               cluster_domain: str = DEFAULT_CLUSTER_DOMAIN,
               always_megascale: bool = False) -> None:
    """Make ``container`` of ``pod_spec`` a GPU worker of slice
    ``slice_idx``, in place: the GPU limits and requests, the product's
    node selector, and the env block, whose names the container already
    sets are left as it sets them.  The MEGASCALE block comes with more
    than one slice (a notebook) or, ``always_megascale``, always, with
    the elastic marker (a job's worker: ``num_slices`` is the granted
    width, ``spec.num_slices`` the declared one)."""
    num_slices = spec.num_slices if num_slices is None else num_slices
    resources = container.setdefault("resources", {})
    resources.setdefault("limits", {}).update(spec.pod_resources())
    resources.setdefault("requests", {}).update(spec.pod_resources())
    pod_spec.setdefault("nodeSelector", {}).update(spec.node_selectors())
    sts_name = slice_sts_name(name, slice_idx)
    hostnames = ",".join(_worker_dns(name, ns, f"{sts_name}-{i}",
                                     cluster_domain)
                         for i in range(spec.num_hosts))
    injected = envspec.gpu_bootstrap_env(gpus_per_host=spec.gpus_per_pod,
                                         num_hosts=spec.num_hosts,
                                         hostnames=hostnames)
    if always_megascale or spec.multi_slice:
        injected += envspec.megascale_env(
            slice_idx, num_slices,
            _worker_dns(name, ns, f"{name}-0", cluster_domain))
    if always_megascale:
        injected += envspec.elastic_env(spec.num_slices)
    env = container.setdefault("env", [])
    have = {e.get("name") for e in env}
    env.extend(e for e in injected if e["name"] not in have)


def launched(command: List[str]) -> List[str]:
    """``command`` run under the launcher: one process a GPU of the
    host."""
    return LAUNCHER + list(command)


def job_worker_container(pod_spec: dict, *, ns: str, name: str,
                         spec: GpuSliceSpec, slice_idx: int = 0,
                         num_slices: Optional[int] = None,
                         cluster_domain: str = DEFAULT_CLUSTER_DOMAIN,
                         checkpoint_dir: Optional[str] = None) -> dict:
    """Make ``pod_spec`` (a copy of the job's template) a worker of slice
    ``slice_idx``, in place, and return its main container
    (``containers[0]``): GPUs and env as ``inject_gpu`` with the
    MEGASCALE block and elastic marker always, ``KFT_CHECKPOINT_DIR``
    where the job names one, and its command under the launcher (a
    gang's trainer always joins the world).  Raises ``ValueError`` for a
    container without a command: the launcher needs one to run."""
    containers = pod_spec.get("containers") or [{}]
    pod_spec["containers"] = containers
    main = containers[0]
    main.setdefault("name", "worker")
    if not main.get("command"):
        raise ValueError(f"job {ns}/{name}: containers[0] has no command "
                         "for the launcher to run")
    inject_gpu(pod_spec, main, ns=ns, name=name, spec=spec,
               slice_idx=slice_idx, num_slices=num_slices,
               cluster_domain=cluster_domain, always_megascale=True)
    if checkpoint_dir:
        env = main["env"]
        if not any(e.get("name") == envspec.ENV_KFT_CHECKPOINT_DIR
                   for e in env):
            env.append({"name": envspec.ENV_KFT_CHECKPOINT_DIR,
                        "value": checkpoint_dir})
    main["command"] = launched(main["command"])
    return main


def serving_container(*, model: str, spec: GpuSliceSpec, revision: int,
                      image: str, port: int = DEFAULT_SERVE_PORT,
                      checkpoint_dir: Optional[str] = None,
                      quantize: Optional[str] = None,
                      mesh: Optional[str] = None,
                      max_seq_len: Optional[int] = None) -> dict:
    """The serving replica's container: ``python -m
    kubeflow_tpu_torch.models.serve`` with the reference's flags, under
    the launcher when ``mesh`` is set (``serve --mesh`` runs one process
    a GPU), the GPUs of ``spec`` and ``KFT_GPUS_PER_HOST``, the revision
    in ``KFT_SERVE_REVISION`` and a readiness probe on ``/readyz``.
    Raises ``ValueError`` for a spec of more than one host: a replica is
    one host, and more hosts are a job's shape."""
    if spec.total_hosts != 1:
        raise ValueError(
            f"{spec.gpus} GPUs x {spec.num_slices} slice(s) span "
            f"{spec.total_hosts} hosts; a serving replica is one host "
            f"(at most {spec.accelerator.gpus_per_host} GPUs); scale "
            "replicas instead")
    command = SERVE_COMMAND + ["--model", model, "--port", str(port)]
    if checkpoint_dir:
        command += ["--checkpoint-dir", checkpoint_dir]
    if quantize:
        command += ["--quantize", quantize]
    if mesh:
        command += ["--mesh", mesh]
    if max_seq_len:
        command += ["--max-seq-len", str(max_seq_len)]
    return {
        "name": "server",
        "image": image,
        "command": launched(command) if mesh else command,
        "ports": [{"containerPort": port}],
        "env": [{"name": ENV_SERVE_REVISION, "value": str(revision)},
                {"name": envspec.ENV_KFT_GPUS_PER_HOST,
                 "value": str(spec.gpus_per_pod)}],
        "resources": {"limits": dict(spec.pod_resources()),
                      "requests": dict(spec.pod_resources())},
        "readinessProbe": {"httpGet": {"path": "/readyz", "port": port},
                           "periodSeconds": 5, "failureThreshold": 3},
    }


def serving_deployment(*, ns: str, name: str, revision: int, replicas: int,
                       model: str, spec: GpuSliceSpec, image: str,
                       port: int = DEFAULT_SERVE_PORT,
                       checkpoint_dir: Optional[str] = None,
                       quantize: Optional[str] = None,
                       mesh: Optional[str] = None,
                       max_seq_len: Optional[int] = None) -> dict:
    """The Deployment of revision ``revision`` of a served model: its
    replicas run ``serving_container`` on nodes of the spec's product.
    The owner reference is the controller's to set."""
    labels = {LABEL_SERVICE_NAME: name, LABEL_REVISION: str(revision)}
    container = serving_container(
        model=model, spec=spec, revision=revision, image=image, port=port,
        checkpoint_dir=checkpoint_dir, quantize=quantize, mesh=mesh,
        max_seq_len=max_seq_len)
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": f"{name}-v{revision}", "namespace": ns,
                     "labels": dict(labels)},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": dict(labels)},
            "template": {
                "metadata": {"labels": dict(labels)},
                "spec": {"containers": [container],
                         "nodeSelector": dict(spec.node_selectors())},
            },
        },
    }
