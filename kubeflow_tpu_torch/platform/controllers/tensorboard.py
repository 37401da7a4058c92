"""Tensorboard controller: Tensorboard CR → Deployment + Service + VirtualService.

The port's copy of ``kubeflow_tpu/platform/controllers/tensorboard.py``
(reference tensorboard_controller.go:67-240): ``spec.logspath`` selects
the log source — ``pvc://claim/subpath`` mounts the claim, ``gs://``
paths mount GCP credentials when a ``user-gcp-sa`` secret exists — and
RWO_PVC_SCHEDULING pins the Deployment to the node of the pod already
mounting the claim (a ReadWriteOnce claim mounts on one node: a
notebook's workspace, where its training run writes its logs).  The
default image is the reference's, serving TensorBoard's own plugins.
"""
from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    DEPLOYMENT,
    SECRET,
    SERVICE,
    TENSORBOARD,
    VIRTUALSERVICE,
    Resource,
    deep_get,
    meta,
    name_of,
    set_owner,
)
from kubeflow_tpu_torch.platform.runtime import Reconciler, Request, Result

DEFAULT_IMAGE = "tensorflow/tensorflow:2.15.0"
GCP_SECRET = "user-gcp-sa"


class TensorboardReconciler(Reconciler):
    def __init__(self, client, *, image: Optional[str] = None,
                 cluster_domain: Optional[str] = None,
                 istio_gateway: Optional[str] = None,
                 rwo_pvc_scheduling: Optional[bool] = None):
        self.client = client
        self.image = image or config.env("TENSORBOARD_IMAGE", DEFAULT_IMAGE)
        self.cluster_domain = cluster_domain or config.env("CLUSTER_DOMAIN", "cluster.local")
        self.istio_gateway = istio_gateway or config.env(
            "ISTIO_GATEWAY", "kubeflow/kubeflow-gateway"
        )
        self.rwo_pvc_scheduling = (
            rwo_pvc_scheduling
            if rwo_pvc_scheduling is not None
            else config.env_bool("RWO_PVC_SCHEDULING", False)
        )

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            tb = self.client.get(TENSORBOARD, req.name, req.namespace)
        except errors.NotFound:
            return None
        from kubeflow_tpu_torch.platform.runtime.apply import create_or_update

        create_or_update(self.client, DEPLOYMENT, self.generate_deployment(tb))
        create_or_update(self.client, SERVICE, self.generate_service(tb))
        create_or_update(self.client, VIRTUALSERVICE, self.generate_virtual_service(tb))
        self._update_status(tb)
        return None

    # -- generation ----------------------------------------------------------

    def generate_deployment(self, tb: Resource) -> Resource:
        ns, name = meta(tb)["namespace"], name_of(tb)
        logspath = deep_get(tb, "spec", "logspath", default="") or ""
        volumes = []
        mounts = []
        env = []
        logdir = logspath
        if logspath.startswith("pvc://"):
            rest = logspath[len("pvc://"):]
            claim, _, subpath = rest.partition("/")
            volumes.append({
                "name": "logs",
                "persistentVolumeClaim": {"claimName": claim},
            })
            mounts.append({"name": "logs", "mountPath": "/logs",
                           **({"subPath": subpath} if subpath else {})})
            logdir = "/logs"
        elif logspath.startswith("gs://") and self._gcp_secret_exists(ns):
            volumes.append({
                "name": "gcp-creds", "secret": {"secretName": GCP_SECRET},
            })
            mounts.append({"name": "gcp-creds",
                           "mountPath": "/secret/gcp", "readOnly": True})
            env.append({
                "name": "GOOGLE_APPLICATION_CREDENTIALS",
                "value": f"/secret/gcp/{GCP_SECRET}.json",
            })
        pod_spec: dict = {
            "containers": [{
                "name": "tensorboard",
                "image": self.image,
                "command": ["/usr/local/bin/tensorboard"],
                "args": [
                    f"--logdir={logdir}",
                    "--bind_all",
                    f"--path_prefix=/tensorboard/{ns}/{name}",
                ],
                "ports": [{"containerPort": 6006}],
                "env": env,
                "volumeMounts": mounts,
            }],
            "volumes": volumes,
        }
        if self.rwo_pvc_scheduling and logspath.startswith("pvc://"):
            claim = logspath[len("pvc://"):].partition("/")[0]
            affinity = self._rwo_affinity(ns, claim)
            if affinity:
                pod_spec["affinity"] = affinity
        deployment = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": pod_spec,
                },
            },
        }
        set_owner(deployment, tb)
        return deployment

    def _gcp_secret_exists(self, ns: str) -> bool:
        try:
            self.client.get(SECRET, GCP_SECRET, ns)
            return True
        except errors.NotFound:
            return False

    def _rwo_affinity(self, ns: str, claim: str) -> Optional[dict]:
        """Pin to the node already mounting the RWO claim (reference
        :168-240): find a running pod using the claim, prefer its node."""
        from kubeflow_tpu_torch.platform.k8s.types import POD

        for pod in self.client.list(POD, ns):
            for vol in deep_get(pod, "spec", "volumes", default=[]) or []:
                if deep_get(vol, "persistentVolumeClaim", "claimName") == claim:
                    node = deep_get(pod, "spec", "nodeName")
                    if node:
                        return {"nodeAffinity": {
                            "requiredDuringSchedulingIgnoredDuringExecution": {
                                "nodeSelectorTerms": [{
                                    "matchExpressions": [{
                                        "key": "kubernetes.io/hostname",
                                        "operator": "In",
                                        "values": [node],
                                    }]
                                }]
                            }
                        }}
        return None

    def generate_service(self, tb: Resource) -> Resource:
        ns, name = meta(tb)["namespace"], name_of(tb)
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "selector": {"app": name},
                "ports": [{"name": "http-tb", "port": 80, "targetPort": 6006}],
            },
        }
        set_owner(svc, tb)
        return svc

    def generate_virtual_service(self, tb: Resource) -> Resource:
        ns, name = meta(tb)["namespace"], name_of(tb)
        vs = {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"tensorboard-{ns}-{name}", "namespace": ns},
            "spec": {
                "hosts": ["*"],
                "gateways": [self.istio_gateway],
                "http": [{
                    "match": [{"uri": {"prefix": f"/tensorboard/{ns}/{name}/"}}],
                    "route": [{"destination": {
                        "host": f"{name}.{ns}.svc.{self.cluster_domain}",
                        "port": {"number": 80},
                    }}],
                }],
            },
        }
        set_owner(vs, tb)
        return vs

    # -- plumbing ------------------------------------------------------------

    def _update_status(self, tb: Resource) -> None:
        ns, name = meta(tb)["namespace"], name_of(tb)
        try:
            deployment = self.client.get(DEPLOYMENT, name, ns)
        except errors.NotFound:
            return
        conditions = deep_get(deployment, "status", "conditions", default=[])
        ready = deep_get(deployment, "status", "readyReplicas", default=0)
        status = {"conditions": conditions, "readyReplicas": ready}
        # Diff-and-patch: only the changed status subtree crosses the wire,
        # with no resourceVersion to conflict on (runtime/apply.py).
        from kubeflow_tpu_torch.platform.runtime.apply import patch_status_diff

        patch_status_diff(self.client, TENSORBOARD, tb, status)


def make_controller(client, **kwargs):
    from kubeflow_tpu_torch.platform.runtime import Controller

    shards = kwargs.pop("shards", None)
    return Controller(
        "tensorboard-controller",
        TensorboardReconciler(client, **kwargs),
        primary=TENSORBOARD,
        owns=[DEPLOYMENT, SERVICE, VIRTUALSERVICE],
        # Deliberately NO primary informer: the Tensorboard CRD is
        # optional, and an informer's failed cache sync is FATAL at
        # Controller.start (it would take the whole manager down on a
        # cluster without the CRD), where the raw watch just retries.
        # The raw watch resumes by resourceVersion (_watch_loop), so the
        # bounded-window full-replay cost the informer would have fixed
        # is fixed anyway.
        resync_period=300.0,
        shards=shards,
    )
