"""GpuJobGangSim: the cluster half of a GPUJob, simulated over FakeKube.

The port's copy of ``kubeflow_tpu/platform/testing/jobsim.py``.  The
GPUJob controller writes slice StatefulSets; something must play the
kubelet AND the training processes for hermetic tests.  This sim watches
a namespace's StatefulSets and, for each gang generation:

* admits every worker pod (``<sts>-<ordinal>``, template labels carried
  over) and marks it Running/ready — the kubelet part;
* optionally runs ``work(job_name, generation, stop)`` ONCE per gang —
  the stand-in for the slice processes' collective training (a test
  passes the port's ``train_loop`` here, on the CPU);
* on the work returning, marks the gang's pods Succeeded (or Failed when
  it raises) — the containers exiting;
* on gang teardown (StatefulSet DELETED — a preemption, or a restart
  after any worker failed), sets that gang's ``stop`` event — the
  SIGTERM a real worker would receive, so a ``train_loop`` running under
  ``stop=`` checkpoints and exits as ``train/run.py``'s handler would.

The gang's size comes from the env contract (``parallel/envspec.py``):
``MEGASCALE_NUM_SLICES`` slices of the StatefulSet's replicas.  Unlike
the reference's sim, a gang stopped by its teardown still marks its pods
with the work's outcome when the work returns, as a worker that exits
after SIGTERM does, so the controller sees the drain end; a pod already
terminal, deleted or taken over by a later generation is left as it
is.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.parallel import envspec
from kubeflow_tpu_torch.platform.apis import gpujob as jobapi
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import POD, STATEFULSET, deep_get


class _Gang:
    def __init__(self):
        self.stop = threading.Event()
        self.pods: List[str] = []
        self.expected = 0         # slices x hosts, read from the env contract
        self.thread: Optional[threading.Thread] = None
        self.stses_seen: set = set()


class GpuJobGangSim:
    def __init__(self, kube, namespace: str, *,
                 work: Optional[Callable] = None):
        self.kube = kube
        self.namespace = namespace
        self.work = work
        self.errors: List[BaseException] = []  # work crashes, for asserts
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._gangs: Dict[Tuple[str, str], _Gang] = {}
        # One gang generation of a job runs at a time: a real teardown
        # waits out the pods' grace before the next generation's pods
        # start, so generation N's checkpoint writes are durable before
        # N+1 restores.
        self._job_locks: Dict[str, threading.Lock] = {}
        self._thread = threading.Thread(target=self._watch_loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            gangs = list(self._gangs.values())
        for gang in gangs:
            gang.stop.set()
        self._thread.join(timeout=5)
        for gang in gangs:
            if gang.thread is not None:
                gang.thread.join(timeout=30)

    # -- internals -----------------------------------------------------------

    def _watch_loop(self) -> None:
        for etype, sts in self.kube.watch(STATEFULSET, self.namespace,
                                          stop=self._stop):
            labels = deep_get(sts, "metadata", "labels", default={}) or {}
            job = labels.get(jobapi.LABEL_GPUJOB_NAME)
            gen = labels.get(jobapi.LABEL_GENERATION)
            if not job or gen is None:
                continue  # not a GPUJob slice (e.g. a notebook's)
            key = (job, gen)
            if etype == "DELETED":
                with self._lock:
                    gang = self._gangs.get(key)
                if gang is not None:
                    gang.stop.set()
                continue
            self._admit(key, sts)

    def _admit(self, key: Tuple[str, str], sts) -> None:
        sts_name = sts["metadata"]["name"]
        replicas = deep_get(sts, "spec", "replicas", default=0)
        tmpl = deep_get(sts, "spec", "template")
        env = {e.get("name"): e.get("value") for e in deep_get(
            tmpl, "spec", "containers", default=[{}])[0].get("env", [])}
        with self._lock:
            gang = self._gangs.setdefault(key, _Gang())
            if sts_name in gang.stses_seen:
                return
            gang.stses_seen.add(sts_name)
            try:
                slices = int(env.get(envspec.ENV_MEGASCALE_NUM_SLICES) or 1)
            except ValueError:
                slices = 1
            gang.expected = slices * replicas
        pods = []
        for i in range(replicas):
            pod_name = f"{sts_name}-{i}"
            pod = {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {
                    "name": pod_name, "namespace": self.namespace,
                    "labels": dict(deep_get(tmpl, "metadata", "labels",
                                            default={}) or {}),
                },
                "spec": deep_get(tmpl, "spec"),
            }
            try:
                self.kube.create(pod)
            except errors.AlreadyExists:
                pass
            except errors.ApiError:
                continue
            try:
                self.kube.set_pod_phase(self.namespace, pod_name,
                                        "Running", ready=True)
            except errors.ApiError:
                continue
            pods.append(pod_name)
        with self._lock:
            gang.pods.extend(pods)
            start_worker = (self.work is not None and gang.thread is None)
            if start_worker:
                gang.thread = threading.Thread(
                    target=self._run_gang, args=(key, gang), daemon=True)
        if start_worker:
            gang.thread.start()

    def _run_gang(self, key: Tuple[str, str], gang: _Gang) -> None:
        """One collective training run per gang generation: wait for the
        full gang to be admitted (every slice's pods), run the work, then
        exit the 'containers' with the work's outcome."""
        job, gen = key
        deadline = 30.0
        step = 0.01
        waited = 0.0
        while waited < deadline and not gang.stop.is_set():
            with self._lock:
                if gang.expected and len(gang.pods) >= gang.expected:
                    break
            threading.Event().wait(step)
            waited += step
        with self._lock:
            job_lock = self._job_locks.setdefault(job, threading.Lock())
        with job_lock:
            try:
                self.work(job, int(gen), gang.stop)
            except BaseException as e:  # surfaced via self.errors
                self.errors.append(e)
                self._finish_pods(gen, gang, "Failed")
                return
            self._finish_pods(gen, gang, "Succeeded")

    def _finish_pods(self, gen: str, gang: _Gang, phase: str) -> None:
        """Mark the gang's pods ``phase``, except those already terminal
        and those whose name a later generation's pod took."""
        with self._lock:
            pods = list(gang.pods)
        for pod_name in pods:
            try:
                pod = self.kube.get(POD, pod_name, self.namespace)
                if (deep_get(pod, "status", "phase") in ("Succeeded",
                                                         "Failed")
                        or deep_get(pod, "metadata", "labels",
                                    jobapi.LABEL_GENERATION) != gen):
                    continue
                self.kube.set_pod_phase(self.namespace, pod_name, phase,
                                        ready=False)
            except errors.ApiError:
                pass
