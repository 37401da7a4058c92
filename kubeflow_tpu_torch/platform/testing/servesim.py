"""InferenceFleetSim: the cluster half of an InferenceService, simulated
over FakeKube.  The port's copy of
``kubeflow_tpu/platform/testing/servesim.py``, whole.

The InferenceService controller writes per-revision Deployments; something
must play the kubelet/ReplicaSet machinery for hermetic tests.  This sim
watches a namespace's Deployments and, for each one carrying the
``inferenceservice-name`` label, keeps the pod set matching
``spec.replicas``:

* creates missing pods (``<deployment>-<ordinal>``, template labels —
  service name + revision — carried over) and marks them Running;
* stamps the ``inferenceservices.kubeflow.org/endpoint`` annotation from
  the ``endpoint_for`` hook, which is how the controller's REAL scrape
  path (/metrics, /readyz) is routed to a hermetic backend — a synthetic
  page in a test, a live model server on the card;
* gates the Ready condition on ``ready_gate`` (pointed at a real
  server's ``/readyz``, a pod is Ready only after the warm one-token
  generate() has actually run: the kubelet readinessProbe, faithfully);
* deletes surplus pods on scale-down and every pod when the Deployment
  goes (rollout drain, scale-to-zero).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from kubeflow_tpu_torch.platform.apis.inferenceservice import (
    ANNOTATION_ENDPOINT,
    LABEL_REVISION,
    LABEL_SERVICE_NAME,
)
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    DEPLOYMENT,
    POD,
    deep_get,
    pod_ready,
)


class InferenceFleetSim:
    def __init__(self, kube, namespace: str, *,
                 endpoint_for: Optional[Callable] = None,
                 ready_gate: Optional[Callable] = None,
                 poll_seconds: float = 0.05):
        """``endpoint_for(service_name, revision, ordinal)`` → base URL
        stamped on the pod (None = no annotation; the controller then
        falls back to podIP, which the sim never sets).
        ``ready_gate(service_name, revision, ordinal)`` → bool: the pod's
        readinessProbe outcome; polled until True."""
        self.kube = kube
        self.namespace = namespace
        self.endpoint_for = endpoint_for
        self.ready_gate = ready_gate
        self.errors: List[BaseException] = []
        self._poll = poll_seconds
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._watch_thread = threading.Thread(target=self._watch_loop,
                                              daemon=True)
        self._thread.start()
        self._watch_thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)
        self._watch_thread.join(timeout=5)

    # -- internals -----------------------------------------------------------

    def _watch_loop(self) -> None:
        # Deployment deltas wake the level loop immediately; the poll is
        # the guarantee (the ready_gate may flip without a delta).
        for _etype, _dep in self.kube.watch(DEPLOYMENT, self.namespace,
                                            stop=self._stop):
            self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._level()
            except BaseException as e:  # noqa: BLE001 — surface in asserts
                self.errors.append(e)
            self._wake.wait(self._poll)
            self._wake.clear()

    def _level(self) -> None:
        deployments = {
            d["metadata"]["name"]: d
            for d in self.kube.list(DEPLOYMENT, self.namespace)
            if deep_get(d, "metadata", "labels", LABEL_SERVICE_NAME)}
        pods_by_dep: Dict[str, List[dict]] = {}
        for pod in self.kube.list(POD, self.namespace):
            name = pod["metadata"]["name"]
            dep = name.rsplit("-", 1)[0]
            labels = deep_get(pod, "metadata", "labels", default={}) or {}
            if labels.get(LABEL_SERVICE_NAME):
                pods_by_dep.setdefault(dep, []).append(pod)
        # Surplus / orphaned pods go first (scale-down, drain).
        for dep_name, pods in pods_by_dep.items():
            want = deep_get(deployments.get(dep_name, {}),
                            "spec", "replicas", default=0) or 0
            for pod in pods:
                ordinal = int(pod["metadata"]["name"].rsplit("-", 1)[1])
                if dep_name not in deployments or ordinal >= want:
                    try:
                        self.kube.delete(POD, pod["metadata"]["name"],
                                         self.namespace)
                    except errors.ApiError:
                        pass
        # Missing pods come up; readiness rides the gate.
        for dep_name, dep in deployments.items():
            want = deep_get(dep, "spec", "replicas", default=0) or 0
            tmpl = deep_get(dep, "spec", "template", default={}) or {}
            labels = dict(deep_get(tmpl, "metadata", "labels",
                                   default={}) or {})
            svc = labels.get(LABEL_SERVICE_NAME, "")
            revision = labels.get(LABEL_REVISION, "0")
            have = {p["metadata"]["name"] for p in
                    pods_by_dep.get(dep_name, [])}
            for i in range(want):
                pod_name = f"{dep_name}-{i}"
                ready = (self.ready_gate is None
                         or bool(self.ready_gate(svc, revision, i)))
                if pod_name in have:
                    # A gated pod may become ready later: re-check.
                    pod = self.kube.get(POD, pod_name, self.namespace)
                    if ready and not pod_ready(pod):
                        self._set_ready(pod_name, True)
                    continue
                annotations = {}
                if self.endpoint_for is not None:
                    url = self.endpoint_for(svc, revision, i)
                    if url:
                        annotations[ANNOTATION_ENDPOINT] = url
                try:
                    self.kube.create({
                        "apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": pod_name,
                                     "namespace": self.namespace,
                                     "labels": labels,
                                     "annotations": annotations},
                        "spec": deep_get(tmpl, "spec", default={}),
                    })
                except errors.AlreadyExists:
                    pass
                self._set_ready(pod_name, ready)

    def _set_ready(self, pod_name: str, ready: bool) -> None:
        try:
            self.kube.set_pod_phase(self.namespace, pod_name, "Running",
                                    ready=ready)
        except errors.ApiError:
            pass
