"""Notebook reconciler: Notebook CR → StatefulSet + Services + VirtualService.

The port's copy of ``kubeflow_tpu/platform/controllers/notebook.py``
with GPU slices (``spec.gpu``) in place of TPU slices; the reconcile is
the reference's (reference notebook_controller.go:89-225 / 361-565):

* ``replicas = num_hosts`` of the slice instead of the reference's
  hard-coded 1 (notebook_controller.go:362) — one pod per GPU host,
  StatefulSet ordinal == worker id; one StatefulSet per slice.
* A headless service always exists for stable per-worker DNS
  (``<name>-<i>.<name>-workers.<ns>``), published before readiness so
  the workers can rendezvous during bring-up.
* The user-facing Service targets **worker 0 only** (pod-name selector) —
  the Jupyter kernel and the culling probe live on the coordinator.
* The GPU limits and requests, the ``nvidia.com/gpu.product`` node
  selector and the worker env (``TPU_WORKER_ID`` from the pod-index
  label, ``TPU_WORKER_HOSTNAMES``, ``KFT_GPUS_PER_HOST``) come from
  ``gpu/pods.py`` ``inject_gpu``.
* Stop/start (``kubeflow-resource-stopped``) scales the whole slice to 0
  and back atomically — all workers, one replicas field.

``make_controller`` drives the reconciler from watches: every watched
kind is sourced from an informer (``runtime/informer.py``), and the
reconcile reads pods, StatefulSets, events and its children from the
same indexed caches.  A reconciler built bare on a client
(``reconcile(Request(ns, name))``) reads the client instead, with the
same results.
"""
from __future__ import annotations

import copy
import json
import time
from typing import Dict, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.gpu import pods
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    EVENT,
    NOTEBOOK,
    POD,
    PODDISRUPTIONBUDGET,
    SERVICE,
    STATEFULSET,
    VIRTUALSERVICE,
    Resource,
    deep_get,
    meta,
    name_of,
    parse_timestamp,
    pod_ready,
    set_owner,
    thaw,
)
from kubeflow_tpu_torch.platform.runtime import EventRecorder, Reconciler, Request, Result
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.platform.runtime import apply
from kubeflow_tpu_torch.platform.runtime.apply import merge_patch_for, patch_status_diff
from kubeflow_tpu_torch.platform.runtime.flight import shared_pool

HASH_ANNOTATION = "notebooks.kubeflow.org/generated-hash"


class _SliceNameConflict(Exception):
    """A slice StatefulSet name is already owned by a different notebook."""


class NotebookReconciler(Reconciler):
    def __init__(self, client, *, use_istio: Optional[bool] = None,
                 istio_gateway: Optional[str] = None,
                 cluster_domain: Optional[str] = None,
                 add_fsgroup: Optional[bool] = None,
                 mirror_min_interval: Optional[float] = None,
                 informers: Optional[dict] = None):
        self.client = client
        # GVK -> Informer (make_controller wires them): the reads of pods,
        # StatefulSets, events and children come from the indexed caches,
        # O(matches) instead of a LIST a reconcile.  Absent, reads go to
        # the client.  The cache is updated before the controller's
        # informer-sourced mappers enqueue, so a reconcile triggered by a
        # delta sees it.
        self.informers: dict = informers or {}
        self.recorder = EventRecorder(client, "notebook-controller")
        # Bounded shared fan-out for independent secondary writes: the
        # slice StatefulSets and the Service/headless-Service/PDB/
        # VirtualService quartet have no ordering dependency on each
        # other, so they fly concurrently (runtime/flight.py) while
        # status aggregation still waits on every result.
        self.flights = shared_pool()
        self.use_istio = (
            use_istio if use_istio is not None else config.env_bool("USE_ISTIO", True)
        )
        self.istio_gateway = istio_gateway or config.env(
            "ISTIO_GATEWAY", "kubeflow/kubeflow-gateway"
        )
        self.cluster_domain = cluster_domain or config.env("CLUSTER_DOMAIN", "cluster.local")
        self.add_fsgroup = (
            add_fsgroup if add_fsgroup is not None else config.env_bool("ADD_FSGROUP", True)
        )
        # (ns, name) -> monotonic time of the last event-mirroring pass.
        self._mirror_last: Dict[tuple, float] = {}
        self.mirror_min_interval = (
            mirror_min_interval
            if mirror_min_interval is not None
            else self.MIRROR_MIN_INTERVAL_SECONDS
        )

    # -- cache-backed reads ---------------------------------------------------

    def _cached_get(self, gvk, name: str, ns: str) -> Optional[Resource]:
        """One object by key: a read-only cache view when the kind's
        informer is wired and synced, a live GET otherwise; None when it
        is not found.  A writer thaws first; a create against a lagging
        cache's None gets AlreadyExists and re-reads at the call site."""
        from kubeflow_tpu_torch.platform.runtime.informer import (
            cache_or_client_get,
        )

        return cache_or_client_get(self.informers.get(gvk), self.client,
                                   gvk, name, ns)

    def _pods_of(self, ns: str, name: str) -> List[Resource]:
        """This notebook's worker pods: the indexed cache when wired, a
        label-selector LIST otherwise."""
        inf = self.informers.get(POD)
        if inf is not None:
            return inf.index_list("notebook", f"{ns}/{name}")
        return self.client.list(
            POD, ns, label_selector={nbapi.LABEL_NOTEBOOK_NAME: name}
        )

    def _stses_of(self, ns: str, name: str) -> List[Resource]:
        """This notebook's slice StatefulSets, for stale-slice GC.  From a
        cache this is safe: a slice missing from a lagging cache is only
        skipped this pass, never deleted for its absence."""
        inf = self.informers.get(STATEFULSET)
        if inf is not None:
            return inf.index_list("notebook", f"{ns}/{name}")
        return self.client.list(
            STATEFULSET, ns,
            label_selector={nbapi.LABEL_NOTEBOOK_NAME: name})

    def _events_involving(self, ns: str, kind: str, name: str) -> List[Resource]:
        """Events on one involved object: the indexed cache, or a field-
        selected LIST (involvedObject.* is apiserver-indexed for Events)."""
        inf = self.informers.get(EVENT)
        if inf is not None:
            return inf.index_list("involved", f"{ns}/{kind}/{name}")
        return self.client.list(
            EVENT, ns,
            field_selector={"involvedObject.kind": kind,
                            "involvedObject.name": name})

    def _pod_events_of_sts(self, ns: str, sts_name: str) -> List[Resource]:
        """Events on ANY worker pod ``<sts>-<ordinal>`` of one StatefulSet,
        including pods that no longer exist."""
        inf = self.informers.get(EVENT)
        if inf is not None:
            return inf.index_list("involved", f"{ns}/Pod-of/{sts_name}")
        out = []
        for ev in self.client.list(EVENT, ns):
            io = ev.get("involvedObject") or {}
            if io.get("kind") != "Pod":
                continue
            prefix, _, ordinal = (io.get("name") or "").rpartition("-")
            if prefix == sts_name and ordinal.isdigit():
                out.append(ev)
        return out

    def _get_event(self, name: str, ns: str) -> Resource:
        inf = self.informers.get(EVENT)
        if inf is not None:
            obj = inf.get(name, ns)
            if obj is None:
                raise errors.NotFound(f'events "{name}" not found in "{ns}"')
            return obj
        return self.client.get(EVENT, name, ns)

    # -- reconcile -----------------------------------------------------------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            notebook = self.client.get(NOTEBOOK, req.name, req.namespace)
        except errors.NotFound:
            # ownerReference GC tears down children; the fleet gauges are
            # scrape-time collectors (metrics.NotebookFleetCollector), so a
            # deleted notebook's GPUs vanish at the next scrape.
            self._mirror_last.pop((req.namespace, req.name), None)
            # Unconditionally: a failed-over leader has no memory of the
            # key but the durable marker still exists — a leaked marker
            # would throttle a same-named successor's first mirror pass.
            try:
                self.client.delete(
                    EVENT, req.name + self.MIRROR_MARKER_SUFFIX,
                    req.namespace,
                )
            except errors.ApiError:
                pass
            return None

        # Invalid specs (an unknown GPU model, a GPU count that fills no
        # host, etc.) are terminal user errors:
        # surface them as a Warning event + status instead of crash-looping
        # the queue (a probe found exactly that failure mode).
        try:
            nbapi.validate(notebook)
        except nbapi.ValidationError as e:
            status = {"conditions": [{
                "type": "Degraded", "status": "True",
                "reason": "InvalidSpec", "message": str(e),
            }]}
            if notebook.get("status") != status:
                self.recorder.event(notebook, "Warning", "InvalidNotebook", str(e))
                patch_status_diff(self.client, NOTEBOOK, notebook, status)
            return None

        stses = self._reconcile_statefulsets(notebook)
        if stses is None:
            # Parked on a slice-name conflict (terminal until renamed).
            return None
        # The four service-layer secondaries are independent of each other
        # (and of the already-written StatefulSets): fly them concurrently.
        # run() waits for ALL and re-raises the first failure AFTER every
        # sibling settled, so one failed write never hides the others and
        # the backoff requeue retries the lot (level-triggered).
        secondary_writes = [
            lambda: self._reconcile_service(notebook),
            lambda: self._reconcile_headless_service(notebook),
            lambda: self._reconcile_pdb(notebook),
        ]
        if self.use_istio:
            secondary_writes.append(
                lambda: self._reconcile_virtual_service(notebook))
        self.flights.run(secondary_writes)
        self._update_status(notebook, stses)
        self._mirror_events(notebook)
        return None

    # -- statefulset ---------------------------------------------------------

    @staticmethod
    def slice_sts_name(name: str, slice_idx: int) -> str:
        """Slice 0 keeps the bare notebook name (so worker 0 is ``<name>-0``
        — UI routing, culling, and status never change); later slices get
        ``<name>-s<i>`` StatefulSets (``gpu/pods.py``)."""
        return pods.slice_sts_name(name, slice_idx)

    def generate_statefulset(
        self, notebook: Resource, slice_idx: int = 0
    ) -> Resource:
        ns = meta(notebook)["namespace"]
        name = name_of(notebook)
        gpu = nbapi.gpu_slice(notebook)
        replicas = 0 if nbapi.is_stopped(notebook) else (gpu.num_hosts if gpu else 1)
        sts_name = self.slice_sts_name(name, slice_idx)

        # thaw(): plain mutable deep copy whether the notebook came from a
        # fresh GET or a frozen cache view (copy_resource under the hood —
        # measurably cheaper than copy.deepcopy on this per-reconcile path).
        pod_spec = thaw(
            deep_get(notebook, "spec", "template", "spec", default={})
        )
        containers = pod_spec.get("containers") or [{}]
        main = containers[0]
        main.setdefault("name", name)

        self._inject_prefix_env(main, ns, name)
        if gpu:
            pods.inject_gpu(pod_spec, main, ns=ns, name=name, spec=gpu,
                            slice_idx=slice_idx,
                            cluster_domain=self.cluster_domain)
        if self.add_fsgroup:
            pod_spec.setdefault("securityContext", {}).setdefault("fsGroup", 100)

        labels = {
            # Per-STS selector label (must be unique per slice so each
            # StatefulSet selects only its own pods)...
            "statefulset": sts_name,
            # ...and the cross-slice notebook label the headless service,
            # PDB, and status aggregation select on.
            nbapi.LABEL_NOTEBOOK_NAME: name,
        }
        sts = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": sts_name,
                "namespace": ns,
                "labels": dict(labels),
            },
            "spec": {
                "replicas": replicas,
                "serviceName": f"{name}-workers",
                "podManagementPolicy": "Parallel",  # all workers at once
                "selector": {"matchLabels": {"statefulset": sts_name}},
                "template": {
                    "metadata": {"labels": dict(labels)},
                    "spec": pod_spec,
                },
            },
        }
        set_owner(sts, notebook)
        return sts

    def _inject_prefix_env(self, container: dict, ns: str, name: str) -> None:
        env = container.setdefault("env", [])
        if not any(e.get("name") == "NB_PREFIX" for e in env):
            env.append({"name": "NB_PREFIX", "value": nbapi.nb_prefix(ns, name)})

    def _reconcile_statefulsets(
        self, notebook: Resource
    ) -> Optional[List[Resource]]:
        """One StatefulSet per slice; stale slice STSes (slices lowered) are
        deleted so their pods don't linger outside the new mesh.  Returns
        None when parked on a slice-name conflict."""
        gpu = nbapi.gpu_slice(notebook)
        n_slices = gpu.num_slices if gpu else 1
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        # Conflict-check every slice name BEFORE writing anything: a partial
        # deployment (slice 0 created, slice 1 conflicted) would hold GPU
        # hosts forever at the rendezvous.
        try:
            for s in range(n_slices):
                self._check_sts_ownership(ns, name, self.slice_sts_name(name, s))
        except _SliceNameConflict as e:
            # A sibling notebook legally named `<name>-s<i>` owns that
            # StatefulSet; fighting over it would flap both workloads.
            # Park this notebook instead — terminal until renamed.
            self.recorder.event(notebook, "Warning", "SliceNameConflict", str(e))
            status = {"conditions": [{
                "type": "Degraded", "status": "True",
                "reason": "SliceNameConflict", "message": str(e),
            }]}
            if notebook.get("status") != status:
                patch_status_diff(self.client, NOTEBOOK, notebook, status)
            return None
        # Every slice StatefulSet is independent (distinct names, one
        # owner): write them concurrently through the bounded pool — a
        # 4-slice notebook pays one round trip of latency, not four.
        out = self.flights.run([
            (lambda s=s: self._reconcile_one_statefulset(notebook, s))
            for s in range(n_slices)
        ])
        expected = {self.slice_sts_name(name, s) for s in range(n_slices)}
        # A transient list failure must raise (requeue with backoff) — a
        # silent skip would leave a scaled-down slice's pods holding GPUs
        # until the next unrelated event.
        owned = self._stses_of(ns, name)
        for sts in owned:
            if name_of(sts) not in expected:
                try:
                    self.client.delete(STATEFULSET, name_of(sts), ns)
                except errors.NotFound:
                    pass
        return out

    def _check_sts_ownership(self, ns: str, notebook_name: str,
                             sts_name: str) -> None:
        current = self._cached_get(STATEFULSET, sts_name, ns)
        if current is None:
            return
        owner = deep_get(current, "metadata", "labels", nbapi.LABEL_NOTEBOOK_NAME)
        if owner != notebook_name:
            raise _SliceNameConflict(
                f"StatefulSet {ns}/{sts_name} belongs to notebook "
                f"{owner or '<unlabelled>'}, not {notebook_name}; rename one "
                f"of the notebooks to resolve the multislice name collision"
            )

    def _reconcile_one_statefulset(
        self, notebook: Resource, slice_idx: int
    ) -> Resource:
        desired = self.generate_statefulset(notebook, slice_idx)
        ns, name = meta(desired)["namespace"], name_of(desired)
        # Semantic ownership via content hash: the live object accretes
        # server defaults (imagePullPolicy, dnsPolicy, ...) that make
        # subtree equality always-false against a real API server; a hash
        # annotation of the *generated* template compares desired-vs-desired
        # (the Deployment pod-template-hash idiom).
        desired_hash = apply.content_hash(desired["spec"]["template"])
        meta(desired).setdefault("annotations", {})[HASH_ANNOTATION] = desired_hash
        current = self._cached_get(STATEFULSET, name, ns)
        if current is None:
            try:
                created = apply.create(self.client, desired)
            except errors.AlreadyExists:
                # Cache lag: a just-created STS hasn't landed in the
                # informer yet.  Re-read fresh and fall through to the
                # compare-and-update path instead of erroring the key —
                # unless the fresh object belongs to a DIFFERENT notebook
                # (a conflict the lagging ownership pre-check missed);
                # never update a sibling's StatefulSet.
                try:
                    current = self.client.get(STATEFULSET, name, ns)
                except errors.NotFound:
                    # Created-then-deleted race: this pass failed its
                    # create (count it); the backoff requeue recreates.
                    metrics.notebook_create_failed_total.inc()
                    raise
                owner = deep_get(current, "metadata", "labels",
                                 nbapi.LABEL_NOTEBOOK_NAME)
                if owner != name_of(notebook):
                    # A genuine create failure (the name belongs to a
                    # sibling): count it — the bare raise skips the
                    # except-ApiError branch below, which used to do so.
                    metrics.notebook_create_failed_total.inc()
                    raise
            except errors.ApiError:
                metrics.notebook_create_failed_total.inc()
                raise
            else:
                metrics.notebook_create_total.inc()
                self.recorder.event(
                    notebook, "Normal", "CreatedStatefulSet",
                    f"Created StatefulSet {name} "
                    f"(replicas={deep_get(desired, 'spec', 'replicas')})",
                )
                return created
        changed_replicas = (deep_get(current, "spec", "replicas")
                            != deep_get(desired, "spec", "replicas"))
        current_hash = deep_get(current, "metadata", "annotations", HASH_ANNOTATION)
        if changed_replicas or current_hash != desired_hash:
            # Diff-and-patch the owned fields only (JSON merge patch): the
            # frozen cache view is read directly — no thaw, no full-object
            # PUT, and no resourceVersion precondition, so a stale cache
            # can no longer turn into a 409 on this path at all.
            spec_patch: dict = {}
            if changed_replicas:
                spec_patch["replicas"] = deep_get(desired, "spec", "replicas")
            if current_hash != desired_hash:
                template_diff = merge_patch_for(
                    deep_get(current, "spec", "template", default={}),
                    desired["spec"]["template"])
                if template_diff is not None:
                    spec_patch["template"] = template_diff
            patch: dict = {
                "metadata": {"annotations": {HASH_ANNOTATION: desired_hash}}}
            if spec_patch:
                patch["spec"] = spec_patch
            return self.client.patch(STATEFULSET, name, patch, ns)
        return current

    # -- services ------------------------------------------------------------

    def generate_service(self, notebook: Resource) -> Resource:
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        gpu = nbapi.gpu_slice(notebook)
        port = nbapi.notebook_port(notebook)
        # Multi-host: route the UI to worker 0, where the kernel lives.
        selector = (
            {"statefulset.kubernetes.io/pod-name": f"{name}-0"}
            if gpu and gpu.multi_host
            else {"statefulset": name}
        )
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "type": "ClusterIP",
                "selector": selector,
                "ports": [{
                    "name": nbapi.service_port_name(name),
                    "port": 80,
                    "targetPort": port,
                    "protocol": "TCP",
                }],
            },
        }
        set_owner(svc, notebook)
        return svc

    def generate_headless_service(self, notebook: Resource) -> Resource:
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        port = nbapi.notebook_port(notebook)
        svc = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"{name}-workers", "namespace": ns},
            "spec": {
                "clusterIP": "None",
                # Resolve worker DNS before readiness: the process group's
                # rendezvous happens while pods are still NotReady.
                "publishNotReadyAddresses": True,
                # Notebook-name label spans every slice's StatefulSet, so
                # cross-slice (DCN) worker DNS resolves through this one
                # governing service.
                "selector": {nbapi.LABEL_NOTEBOOK_NAME: name},
                "ports": [{"name": "coordinator", "port": port, "protocol": "TCP"}],
            },
        }
        set_owner(svc, notebook)
        return svc

    def _reconcile_service(self, notebook: Resource) -> Resource:
        return self._create_or_update_service(self.generate_service(notebook))

    def _reconcile_headless_service(self, notebook: Resource) -> Resource:
        return self._create_or_update_service(self.generate_headless_service(notebook))

    def _create_or_update_service(self, desired: Resource) -> Resource:
        ns, name = meta(desired)["namespace"], name_of(desired)
        desired_hash = apply.content_hash(desired["spec"])
        meta(desired).setdefault("annotations", {})[HASH_ANNOTATION] = desired_hash
        current = self._cached_get(SERVICE, name, ns)
        if current is None:
            try:
                return apply.create(self.client, desired)
            except errors.AlreadyExists:
                # Cache lag — re-read fresh and reconcile against it.
                current = self.client.get(SERVICE, name, ns)
        if deep_get(current, "metadata", "annotations", HASH_ANNOTATION) == desired_hash:
            return current
        # Patch only controller-owned fields; keep server-populated ones
        # (clusterIP is immutable — reference CopyServiceFields preserves
        # it, here by folding the live value into the desired spec before
        # the diff so the patch never touches it).
        want = copy.deepcopy(desired["spec"])
        if "clusterIP" in current.get("spec", {}) and want.get("clusterIP") != "None":
            want["clusterIP"] = current["spec"]["clusterIP"]
        patch: dict = {
            "metadata": {"annotations": {HASH_ANNOTATION: desired_hash}}}
        spec_diff = merge_patch_for(current.get("spec"), want)
        if spec_diff is not None:
            patch["spec"] = spec_diff
        return self.client.patch(SERVICE, name, patch, ns)

    # -- pod disruption budget ----------------------------------------------

    def generate_pdb(self, notebook: Resource) -> Optional[Resource]:
        """Multi-host slices are all-or-nothing: evicting one worker kills
        the whole slice's process group, so voluntary disruptions
        must never take a single worker.  minAvailable = num_hosts blocks
        them all; single-host notebooks need no PDB (no reference analogue
        — the reference never schedules multi-pod workloads)."""
        gpu = nbapi.gpu_slice(notebook)
        if not gpu or not gpu.multi_host or nbapi.is_stopped(notebook):
            return None
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        pdb = {
            "apiVersion": "policy/v1",
            "kind": "PodDisruptionBudget",
            "metadata": {"name": f"{name}-slice", "namespace": ns},
            "spec": {
                "minAvailable": gpu.total_hosts,
                "selector": {"matchLabels": {nbapi.LABEL_NOTEBOOK_NAME: name}},
            },
        }
        set_owner(pdb, notebook)
        return pdb

    def _reconcile_pdb(self, notebook: Resource) -> None:
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        desired = self.generate_pdb(notebook)
        pdb_name = f"{name}-slice"
        current = self._cached_get(PODDISRUPTIONBUDGET, pdb_name, ns)
        if desired is None:
            # Single-host, stopped, or spec changed away from multi-host: a
            # leftover PDB would block node drains forever.  Read-then-
            # delete keeps the common single-host reconcile off the API
            # server's write path entirely.
            if current is not None:
                try:
                    self.client.delete(PODDISRUPTIONBUDGET, pdb_name, ns)
                except errors.NotFound:
                    pass
            return
        if current is None:
            try:
                apply.create(self.client, desired)
            except errors.AlreadyExists:
                current = self.client.get(PODDISRUPTIONBUDGET, pdb_name, ns)
            else:
                return
        spec_diff = merge_patch_for(current.get("spec"), desired.get("spec"))
        if spec_diff is not None:
            self.client.patch(PODDISRUPTIONBUDGET, pdb_name,
                              {"spec": spec_diff}, ns)

    # -- istio ---------------------------------------------------------------

    def generate_virtual_service(self, notebook: Resource) -> Resource:
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        prefix = nbapi.nb_prefix(ns, name) + "/"
        annotations = deep_get(notebook, "metadata", "annotations", default={}) or {}
        rewrite = annotations.get(nbapi.ANNOTATION_REWRITE_URI) or "/"
        route: dict = {
            "destination": {
                "host": f"{name}.{ns}.svc.{self.cluster_domain}",
                "port": {"number": 80},
            }
        }
        headers_set = annotations.get(nbapi.ANNOTATION_HEADERS_REQUEST_SET)
        http_route: dict = {
            "match": [{"uri": {"prefix": prefix}}],
            "rewrite": {"uri": rewrite},
            "route": [route],
            "timeout": "300s",
        }
        if headers_set:
            try:
                http_route["headers"] = {"request": {"set": json.loads(headers_set)}}
            except ValueError:
                pass
        vs = {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"notebook-{ns}-{name}", "namespace": ns},
            "spec": {
                "hosts": ["*"],
                "gateways": [self.istio_gateway],
                "http": [http_route],
            },
        }
        set_owner(vs, notebook)
        return vs

    def _reconcile_virtual_service(self, notebook: Resource) -> Resource:
        desired = self.generate_virtual_service(notebook)
        ns, name = meta(desired)["namespace"], name_of(desired)
        current = self._cached_get(VIRTUALSERVICE, name, ns)
        if current is None:
            try:
                return apply.create(self.client, desired)
            except errors.AlreadyExists:
                current = self.client.get(VIRTUALSERVICE, name, ns)
        spec_diff = merge_patch_for(current.get("spec"), desired.get("spec"))
        if spec_diff is not None:
            return self.client.patch(VIRTUALSERVICE, name,
                                     {"spec": spec_diff}, ns)
        return current

    # -- event mirroring -----------------------------------------------------

    MIRROR_ANNOTATION = "notebooks.kubeflow.org/mirrored-from"
    # Durable record of the last mirroring pass, one Event per notebook:
    # a failed-over leader seeds its throttle window from it, so a restart
    # during an event storm doesn't re-list every event for every notebook
    # at once (VERDICT r1 item 10).  involvedObject is the controller, not
    # the notebook — user event feeds filter by involvedObject and must
    # not see bookkeeping.
    MIRROR_MARKER_SUFFIX = ".mirror-pass"
    # During the event storms mirroring exists to surface (FailedScheduling
    # on exhausted GPU capacity) each event also triggers a reconcile; even
    # with indexed reads the mirror writes would churn.  Bound it: at most
    # one mirroring pass per notebook per window.
    MIRROR_MIN_INTERVAL_SECONDS = 10.0

    def _mirror_events(self, notebook: Resource) -> None:
        """Re-emit Pod/StatefulSet Events onto the Notebook CR so users see
        scheduling failures (FailedScheduling on GPU capacity, image pulls)
        in the UI without inspecting pods — the reference does the same
        (reference notebook_controller.go:94-118, event→notebook mapping
        :608-644).  Idempotent: the mirror's deterministic name encodes the
        source event uid + count, so re-reconciles hit AlreadyExists."""
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        now = time.monotonic()
        last = self._mirror_last.get((ns, name))
        if last is None:
            last = self._seed_mirror_throttle(ns, name, now)
        if last is not None and now - last < self.mirror_min_interval:
            self._mirror_last[(ns, name)] = last
            return  # the periodic resync guarantees a later pass
        self._mirror_last[(ns, name)] = now
        created_ts = deep_get(notebook, "metadata", "creationTimestamp")
        sts_names = _notebook_sts_names(notebook)
        # Field-selected lists per involved object, not one namespace-wide
        # event list: the apiserver indexes Events on involvedObject.*, and
        # an unselected list made every notebook's mirror pass O(all events
        # in the namespace) — quadratic across a fleet wave (bench_scale.py;
        # on 600 notebooks the cold-start passes alone copied 360k events).
        events = []
        try:
            for sts in sorted(sts_names):
                events.extend(self._events_involving(ns, "StatefulSet", sts))
                # ALL worker-pod events of this STS, any ordinal, whether
                # or not the pod still exists (deleted workers' Warnings
                # must keep mirroring) — one prefix-indexed lookup; the
                # client fallback filters a namespace event list exactly
                # like _event_involves_notebook.
                events.extend(self._pod_events_of_sts(ns, sts))
            # Previously-created mirrors (they involve the Notebook) —
            # dedup locally instead of a guaranteed-409 create per
            # mirrored event on every reconcile.
            mirrors = self._events_involving(ns, NOTEBOOK.kind, name)
        except errors.ApiError:
            return
        existing = {name_of(e): e for e in mirrors}
        for ev in events:
            if not _event_involves_notebook(ev, sts_names):
                continue
            # Only events from this notebook's lifetime: a recreated
            # notebook must not inherit its predecessor's failures.
            # events.k8s.io-style events carry eventTime instead of the
            # deprecated first/lastTimestamp; metadata.creationTimestamp is
            # the final fallback so the filter can't be skipped entirely.
            last_ts = (
                ev.get("lastTimestamp")
                or ev.get("firstTimestamp")
                or ev.get("eventTime")
                or deep_get(ev, "metadata", "creationTimestamp")
                or ""
            )
            if created_ts and last_ts and last_ts[:19] < created_ts[:19]:
                continue
            src_uid = deep_get(ev, "metadata", "uid") or apply.content_hash(
                [ev.get("reason"), ev.get("message"), last_ts]
            )
            # One mirror per source event; count bumps on a recurring source
            # (FailedScheduling retries) update the mirror in place instead
            # of minting a new Event per bump.
            mirror_name = f"{name}.{src_uid[:10]}"
            prior = existing.get(mirror_name)
            if prior is None and any(
                k.startswith(mirror_name + ".") for k in existing
            ):
                # A mirror created under the legacy <name>.<uid>.<count>
                # naming already covers this source event; don't duplicate
                # it — it ages out of etcd on its own.
                continue
            if prior is not None:
                if (prior.get("count", 1), prior.get("lastTimestamp")) != (
                    ev.get("count", 1), last_ts,
                ):
                    # Count bump on the cached read: a two-field merge
                    # patch (no thaw, no RV, conflict-free) instead of a
                    # full-object update of the frozen view.
                    try:
                        self.client.patch(
                            EVENT, name_of(prior),
                            {"count": ev.get("count", 1),
                             "lastTimestamp": last_ts},
                            ns)
                    except errors.ApiError:
                        pass
                continue
            mirror = {
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {
                    "name": mirror_name,
                    "namespace": ns,
                    "annotations": {
                        self.MIRROR_ANNOTATION: (
                            f"{ev.get('involvedObject', {}).get('kind', '')}/"
                            f"{ev.get('involvedObject', {}).get('name', '')}"
                        )
                    },
                },
                "involvedObject": {
                    "apiVersion": f"{NOTEBOOK.group}/{NOTEBOOK.version}",
                    "kind": NOTEBOOK.kind,
                    "name": name,
                    "namespace": ns,
                    "uid": meta(notebook).get("uid", ""),
                },
                "reason": ev.get("reason", ""),
                "message": ev.get("message", ""),
                "type": ev.get("type", "Normal"),
                "source": {"component": "notebook-controller"},
                "firstTimestamp": ev.get("firstTimestamp", last_ts),
                "lastTimestamp": last_ts,
                "count": ev.get("count", 1),
            }
            try:
                apply.create(self.client, mirror)
            except errors.AlreadyExists:
                pass
            except errors.ApiError:
                continue
        self._stamp_mirror_marker(ns, name)

    def _seed_mirror_throttle(self, ns: str, name: str, now: float):
        """Cold-start throttle seed for a restarted/failed-over controller:
        one GET of the durable marker Event per cold key (then memory takes
        over), instead of an unthrottled full event list per notebook."""
        try:
            marker = self._get_event(name + self.MIRROR_MARKER_SUFFIX, ns)
        except errors.ApiError:
            return None
        t = parse_timestamp(marker.get("lastTimestamp"))
        if t is None:
            return None
        age = max(0.0, time.time() - t)
        return now - age

    def _stamp_mirror_marker(self, ns: str, name: str) -> None:
        from datetime import datetime, timezone

        ts = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        marker_name = name + self.MIRROR_MARKER_SUFFIX
        marker = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": marker_name, "namespace": ns},
            "involvedObject": {
                "kind": "Controller",
                "name": "notebook-controller",
                "namespace": ns,
            },
            "reason": "EventMirrorPass",
            "message": f"event mirroring pass for Notebook {name}",
            "type": "Normal",
            "source": {"component": "notebook-controller"},
            "firstTimestamp": ts,
            "lastTimestamp": ts,
            "count": 1,
        }
        try:
            apply.create(self.client, marker)
            return
        except errors.AlreadyExists:
            pass
        except errors.ApiError:
            return
        try:
            prior = self.client.get(EVENT, marker_name, ns)
            self.client.patch(
                EVENT, marker_name,
                {"lastTimestamp": ts,
                 "count": int(prior.get("count", 1)) + 1},
                ns)
        except errors.ApiError:
            pass

    # -- status --------------------------------------------------------------

    def _update_status(self, notebook: Resource, stses: List[Resource]) -> None:
        ns, name = meta(notebook)["namespace"], name_of(notebook)
        pods = self._pods_of(ns, name)
        ready = sum(1 for p in pods if pod_ready(p))
        worker0 = next(
            (p for p in pods if name_of(p) == f"{name}-0"), None
        )
        status: dict = {
            "readyReplicas": ready,
            "replicas": sum(
                deep_get(s, "spec", "replicas", default=0) for s in stses
            ),
        }
        if worker0:
            status["conditions"] = deep_get(worker0, "status", "conditions", default=[])
            cstates = deep_get(worker0, "status", "containerStatuses", default=[])
            if cstates:
                status["containerState"] = cstates[0].get("state", {})
        if notebook.get("status") != status:
            replicas = status["replicas"]
            was_ready = deep_get(notebook, "status", "readyReplicas", default=0)
            if replicas and ready == replicas and was_ready < replicas:
                # First transition to fully-ready: the spawn-to-ready metric
                # (BASELINE.md headline on the platform side).
                created = deep_get(notebook, "metadata", "creationTimestamp")
                elapsed = _seconds_since(created)
                if elapsed is not None:
                    metrics.notebook_spawn_seconds.observe(elapsed)
            # Diff-and-patch the changed subtree: a readiness tick sends
            # {"status":{"readyReplicas":N}} instead of the whole object,
            # and the RV-free merge patch cannot 409 against concurrent
            # spec writes — the hot-path conflict class under chaos.
            patch_status_diff(self.client, NOTEBOOK, notebook, status)


def _seconds_since(timestamp: Optional[str]) -> Optional[float]:
    then = parse_timestamp(timestamp)
    if then is None:
        return None
    return max(0.0, time.time() - then)


def pods_to_notebook_requests(obj: Resource) -> List[Request]:
    """Watch mapper: pod events → owning Notebook (by notebook-name label)."""
    labels = deep_get(obj, "metadata", "labels", default={}) or {}
    nb = labels.get(nbapi.LABEL_NOTEBOOK_NAME)
    if not nb:
        return []
    return [Request(deep_get(obj, "metadata", "namespace", default=""), nb)]


def _strip_slice_suffix(sts_name: str) -> str:
    """``nb-s2`` → ``nb`` (multislice STS naming); anything else unchanged."""
    prefix, _, tail = sts_name.rpartition("-")
    if prefix and tail.startswith("s") and tail[1:].isdigit():
        return prefix
    return sts_name


def _notebook_sts_names(notebook: Resource) -> set:
    """The exact StatefulSet names this notebook owns — a sibling notebook
    legally named ``<name>-s1`` must never be treated as one of our slices."""
    name = name_of(notebook)
    gpu = nbapi.gpu_slice_or_none(notebook)
    n_slices = gpu.num_slices if gpu else 1
    return {
        NotebookReconciler.slice_sts_name(name, s) for s in range(n_slices)
    }


def _event_involves_notebook(ev: Resource, sts_names: set) -> bool:
    io = ev.get("involvedObject") or {}
    kind, obj_name = io.get("kind"), io.get("name", "")
    if kind == "StatefulSet":
        return obj_name in sts_names
    if kind == "Pod":
        prefix, _, ordinal = obj_name.rpartition("-")
        return prefix in sts_names and ordinal.isdigit()
    return False


def events_to_notebook_requests(obj: Resource) -> List[Request]:
    """Watch mapper: a k8s Event on a notebook pod/STS → the owning Notebook
    (reference notebook_controller.go:608-644).  Pods named <nb>-<ordinal>
    map by stripping the StatefulSet ordinal; non-notebook hits resolve to
    NotFound in reconcile and are dropped there."""
    ns = deep_get(obj, "metadata", "namespace", default="")
    io = obj.get("involvedObject") or {}
    kind, obj_name = io.get("kind"), io.get("name", "")
    if kind == "StatefulSet":
        reqs = [Request(ns, obj_name)]
        stripped = _strip_slice_suffix(obj_name)
        if stripped != obj_name:
            # Multislice STS <nb>-s<i>: also try the owning notebook; the
            # wrong candidate resolves to NotFound in reconcile and drops.
            reqs.append(Request(ns, stripped))
        return reqs
    if kind == "Pod":
        prefix, _, ordinal = obj_name.rpartition("-")
        if prefix and ordinal.isdigit():
            reqs = [Request(ns, prefix)]
            stripped = _strip_slice_suffix(prefix)
            if stripped != prefix:
                reqs.append(Request(ns, stripped))
            return reqs
    return []


def _pod_notebook_index(pod: Resource) -> List[str]:
    labels = deep_get(pod, "metadata", "labels", default={}) or {}
    nb = labels.get(nbapi.LABEL_NOTEBOOK_NAME)
    ns = deep_get(pod, "metadata", "namespace", default="")
    return [f"{ns}/{nb}"] if nb else []


def _event_involved_index(ev: Resource) -> List[str]:
    io = ev.get("involvedObject") or {}
    kind, name = io.get("kind"), io.get("name")
    ns = deep_get(ev, "metadata", "namespace", default="")
    if not (kind and name):
        return []
    keys = [f"{ns}/{kind}/{name}"]
    if kind == "Pod":
        # Pod events are also filed under their StatefulSet (the name
        # without its ordinal), so the mirror pass reads every worker's
        # events in one lookup, a deleted pod's included.
        prefix, _, ordinal = name.rpartition("-")
        if prefix and ordinal.isdigit():
            keys.append(f"{ns}/Pod-of/{prefix}")
    return keys


def make_controller(client, **kwargs):
    """The notebook controller: every watched kind from an informer
    cache (the reference's notebook_controller.go:684-733 sources), the
    reconciler reading the same caches, the fleet gauges hooked for the
    controller's life, and a resync every 300 s.  ``shards`` (a
    ``ShardCoordinator``) is the Controller's, not the reconciler's,
    which sees a refused write as a Conflict."""
    from kubeflow_tpu_torch.platform.runtime import Controller
    from kubeflow_tpu_torch.platform.runtime.informer import Informer

    shards = kwargs.pop("shards", None)

    informers = {
        NOTEBOOK: Informer(client, NOTEBOOK),
        POD: Informer(client, POD,
                      indexers={"notebook": _pod_notebook_index}),
        STATEFULSET: Informer(client, STATEFULSET,
                              indexers={"notebook": _pod_notebook_index}),
        SERVICE: Informer(client, SERVICE),
        PODDISRUPTIONBUDGET: Informer(client, PODDISRUPTIONBUDGET),
        EVENT: Informer(client, EVENT,
                        indexers={"involved": _event_involved_index}),
    }
    # The VirtualService kind exists only on Istio clusters, and a cache
    # that cannot sync is fatal at start: its informer and its owns-watch
    # follow USE_ISTIO, resolved once and handed to the reconciler so the
    # two cannot disagree.
    use_istio = kwargs.get("use_istio")
    if use_istio is None:
        use_istio = config.env_bool("USE_ISTIO", True)
    kwargs["use_istio"] = use_istio
    owns = [STATEFULSET, SERVICE, PODDISRUPTIONBUDGET]
    if use_istio:
        informers[VIRTUALSERVICE] = Informer(client, VIRTUALSERVICE)
        owns.append(VIRTUALSERVICE)
    return Controller(
        "notebook-controller",
        NotebookReconciler(client, informers=informers, **kwargs),
        primary=NOTEBOOK,
        owns=owns,
        watches=[
            (POD, pods_to_notebook_requests),
            (EVENT, events_to_notebook_requests),
        ],
        informers=informers,
        # The fleet gauges list over this client at scrape time, for as
        # long as the controller runs.
        on_start=lambda: metrics.register_fleet_collector(client),
        on_stop=lambda: metrics.register_fleet_collector(None),
        # The safety net for drift no watch covers.
        resync_period=300.0,
        shards=shards,
        # The server-side subscriptions of the watched kinds: a pod by its
        # notebook-name label (pods_to_notebook_requests' key), an event
        # by its involved object's name candidates (a superset of what
        # events_to_notebook_requests resolves).
        shard_sources={POD: f"label={nbapi.LABEL_NOTEBOOK_NAME}",
                       EVENT: "involved"},
    )
