"""InferenceService reconciler: a CR into per-revision Deployments, a
Service and a VirtualService, autoscaled from its replicas' telemetry.
The port's copy of ``kubeflow_tpu/platform/controllers/inferenceservice.py``
with GPU replicas.

* **GPU replicas.**  Each Deployment pod is one ``models/serve.py``
  process over one host's GPUs: the Deployment is ``gpu/pods.py``
  ``serving_deployment`` (``nvidia.com/gpu`` limits, the product's node
  selector, ``--checkpoint-dir``, ``--quantize``, ``--mesh`` under the
  launcher, ``--max-seq-len``), with a ``/readyz`` readinessProbe that
  runs a real one-token ``generate()`` before the pod counts as Ready.
* **Rolling weight updates.**  Every pod-spec-affecting field is hashed
  into a revision (``apis/inferenceservice.revision_hash``).  A change
  creates ``<name>-v<rev+1>`` next to the serving Deployment, and only
  after a new-revision pod is Ready AND answers the controller's own
  ``/readyz`` probe does the Service selector flip to the new revision
  label; the old Deployment is deleted after the flip.
* **Telemetry-driven autoscaling.**  Each reconcile scrapes the ready
  replicas' ``/metrics`` through ``telemetry/fleetscrape.py`` into a
  TSDB (queue depth, TTFT p99 from the histogram buckets, decode-slot
  occupancy, the request counter) and feeds the pure decision function
  of ``runtime/autoscale.py``: target tracking up, cooldown-limited
  halving down, scale-to-zero after the idle window, a wake on the
  activator's annotation (or the traffic counter moving).  The scale
  state lives on the CR status, so any replica, and a restarted
  controller, continues the same decision sequence.
* **One quota truth.**  The service's target width x one replica's GPUs
  is a declared charge in the GPUJob admission ledger
  (``runtime/jobqueue.py``); a scale-up is clamped to the namespace's
  free GPUs (``service_headroom``).
* **The front door's discovery.**  Each pass publishes the ready
  serving-revision endpoints and the TTFT target into the activator's
  ``EndpointBook`` (``platform/activator.py``), and a delete forgets
  them.

Runs under the same ``FencedClient``/``shards=`` HA regime as the other
controllers.  Drive it on the CPU with ``testing/servesim.py``'s
``InferenceFleetSim`` playing the Deployment's pods::

    sim = InferenceFleetSim(kube, "ns", endpoint_for=url_of)
    mgr = Manager(kube); mgr.add(inferenceservice_controller(kube))
"""
from __future__ import annotations

import time
import urllib.request
from typing import Dict, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.apis import inferenceservice as api
from kubeflow_tpu_torch.platform.gpu import pods as gpu_pods
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    DEPLOYMENT,
    INFERENCESERVICE,
    POD,
    SERVICE,
    VIRTUALSERVICE,
    Resource,
    deep_get,
    meta,
    name_of,
    pod_ready,
    set_owner,
    thaw,
)
from kubeflow_tpu_torch.platform.runtime import (
    EventRecorder,
    Reconciler,
    Request,
    Result,
)
from kubeflow_tpu_torch.platform.runtime import jobqueue as jq
from kubeflow_tpu_torch.platform.runtime import metrics
from kubeflow_tpu_torch.platform.runtime.apply import (
    create_or_update,
    patch_status_diff,
)
from kubeflow_tpu_torch.platform.runtime.autoscale import (
    ServeSample,
    decide_scale,
    state_from_status,
    state_to_status,
    targets_from_spec,
)
from kubeflow_tpu_torch.telemetry.metrics import parse_text, quantile_from_buckets

DEFAULT_IMAGE = "ghcr.io/kubeflow-tpu/platform:latest"
# Scrape/decision cadence while replicas exist; also the requeue backstop
# for rollouts and wake watching.
DEFAULT_SYNC_S = 10.0
SCRAPE_TIMEOUT_S = 2.0
# A replica is reached directly: no proxy from the environment.
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _default_scraper(url: str) -> Optional[str]:
    """GET ``url`` with a short timeout; None on any failure (a replica
    that won't answer its scrape is simply absent from this pass)."""
    try:
        with _OPENER.open(url, timeout=SCRAPE_TIMEOUT_S) as resp:
            return resp.read().decode("utf-8", "replace")
    except Exception:
        return None


def parse_serve_pages(texts: List[str]):
    """Reduce N replicas' /metrics pages in ONE parsing pass: a
    ``ServeSample`` (per-replica means for the gauges, summed counters,
    p99 over the merged TTFT buckets) plus the raw merged bucket map —
    the controller diffs the buckets between passes.  Pure
    text-in/value-out so tests and the bench drive it without a
    socket."""
    n = 0
    queue_sum = 0.0
    active_sum = 0.0
    slots_sum = 0.0
    requests = 0.0
    buckets: Dict[float, float] = {}
    for text in texts:
        if not text:
            continue
        n += 1
        for name, labels, value in parse_text(text):
            if name == "serve_queue_depth":
                queue_sum += value
            elif name == "serve_decode_slots_active":
                active_sum += value
            elif name == "serve_decode_slots":
                slots_sum += value
            elif name == "generate_requests_total":
                requests += value
            elif name == "serve_time_to_first_token_seconds_bucket":
                le = float(labels["le"])
                buckets[le] = buckets.get(le, 0.0) + value
    if n == 0:
        return ServeSample(), buckets
    occupancy = (active_sum / slots_sum) if slots_sum > 0 else None
    return ServeSample(
        replicas_scraped=n,
        queue_depth=queue_sum / n,
        ttft_p99_s=quantile_from_buckets(buckets, 0.99),
        slot_occupancy=occupancy,
        requests_total=requests,
    ), buckets


def parse_serve_sample(texts: List[str]) -> ServeSample:
    return parse_serve_pages(texts)[0]


class InferenceServiceReconciler(Reconciler):
    def __init__(self, client, *, image: Optional[str] = None,
                 cluster_domain: Optional[str] = None,
                 istio_gateway: Optional[str] = None,
                 informers: Optional[dict] = None,
                 queue: Optional[jq.JobQueue] = None,
                 scraper=None, sync_period: Optional[float] = None,
                 tsdb=None, now=time.time, book=None):
        self.client = client
        self.informers: dict = informers or {}
        self.recorder = EventRecorder(client, "inferenceservice-controller")
        self.image = image or config.env("INFERENCESERVICE_IMAGE",
                                         DEFAULT_IMAGE)
        self.cluster_domain = cluster_domain or config.env(
            "CLUSTER_DOMAIN", "cluster.local")
        self.istio_gateway = istio_gateway or config.env(
            "ISTIO_GATEWAY", "kubeflow/kubeflow-gateway")
        # The GPU ledger (shared quota truth with GPUJob admission).
        # make_controller passes an informer-fed instance; bare
        # construction gets a client-backed one rebuilt per decision.
        self.queue = queue if queue is not None else jq.JobQueue(client)
        # scraper(url) -> page text or None: the ONE hook both /metrics
        # scraping and the /readyz flip probe go through, so hermetic
        # harnesses (and the bench) swap a single function.
        self.scraper = scraper or _default_scraper
        self.sync_period = (
            sync_period if sync_period is not None
            else config.env_float("INFERENCESERVICE_SYNC_SECONDS",
                                  DEFAULT_SYNC_S))
        self.now = now
        # The fleet metrics substrate (telemetry/{tsdb,fleetscrape}.py):
        # replica scrapes land in an in-process TSDB and the decision
        # sample is computed from stored series (the TTFT delta is the
        # pass-join of ``fleetscrape.serve_sample``).  Bare construction
        # gets a PRIVATE store, so instances never couple through
        # process state; ``make_controller`` passes the process-shared
        # ``default_tsdb()`` the activator's shed signal reads.
        # In-process either way: after a restart the first pass
        # re-baselines and reports no TTFT signal.
        from kubeflow_tpu_torch.telemetry import fleetscrape
        from kubeflow_tpu_torch.telemetry.tsdb import TSDB

        # Endpoint discovery for the serving front door
        # (platform/activator.py): each reconcile PUBLISHES the ready
        # serving-revision endpoints (and the TTFT SLO target) into the
        # book the activator reads — push, not probe, so the data path
        # never lists pods and never races the informer.  Same
        # private/shared split as ``tsdb``: bare construction gets a
        # PRIVATE book (test instances never couple through process
        # state); ``make_controller`` passes the process-shared
        # ``activator.default_book()`` the front door reads.
        from kubeflow_tpu_torch.platform import activator as _activator

        self.book = book if book is not None else _activator.EndpointBook()
        self.tsdb = tsdb if tsdb is not None else TSDB()
        self.fleet = fleetscrape.FleetScraper(
            self.tsdb, scraper=scraper,
            on_error=lambda reason:
                metrics.inferenceservice_scrape_errors_total.labels(
                    reason=reason).inc(),
            now=now)

    # -- cache-backed reads ---------------------------------------------------

    def _cached_get(self, gvk, name: str, ns: str) -> Optional[Resource]:
        from kubeflow_tpu_torch.platform.runtime.informer import cache_or_client_get

        return cache_or_client_get(self.informers.get(gvk), self.client,
                                   gvk, name, ns)

    def _pods_of(self, ns: str, name: str) -> List[Resource]:
        inf = self.informers.get(POD)
        if inf is not None:
            return inf.index_list("inferenceservice", f"{ns}/{name}")
        return self.client.list(
            POD, ns, label_selector={api.LABEL_SERVICE_NAME: name})

    # -- reconcile ------------------------------------------------------------

    def reconcile(self, req: Request) -> Optional[Result]:
        try:
            svc = self.client.get(INFERENCESERVICE, req.name, req.namespace)
        except errors.NotFound:
            # ownerReference GC tears the Deployments/Service down with
            # the CR; drop the ledger charge, the scrape memory, and the
            # front door's endpoint record now.
            self.queue.forget_service(req.namespace, req.name)
            self.tsdb.drop(matcher={"service": f"{req.namespace}/{req.name}"})
            self.book.forget(f"{req.namespace}/{req.name}")
            return None

        try:
            api.validate(svc)
        except api.ValidationError as e:
            # MERGE into the stored status: wiping it would zero the
            # revision/replica record, and a later revert would then
            # cold-restart the service at revision 1 while the real
            # revision's Deployment kept its GPUs unowned.
            status = dict(thaw(svc.get("status")) or {})
            status["reason"] = "InvalidSpec"
            status["conditions"] = [{
                "type": "Degraded", "status": "True",
                "reason": "InvalidSpec", "message": str(e),
            }]
            if svc.get("status") != status:
                self.recorder.event(svc, "Warning",
                                    "InvalidInferenceService", str(e))
                patch_status_diff(self.client, INFERENCESERVICE, svc, status)
            return None

        ns, name = meta(svc)["namespace"], name_of(svc)
        self.queue.ensure_fresh()
        self.queue.observe_service(svc)
        slice_spec = api.gpu_slice(svc)
        now = self.now()

        # -- revision resolution ---------------------------------------------
        want_hash = api.revision_hash(svc)
        serving_rev = api.revision_of(svc)
        target_rev = api.target_revision_of(svc)
        stored_hash = deep_get(svc, "status", "revisionHash")
        # Transition counters are incremented only AFTER the status
        # commit lands (below): a faulted write replays the whole
        # reconcile, and an eager inc would count one transition N times
        # under a storm.
        deferred_incs = []
        if serving_rev == 0:
            # First reconcile: revision 1 IS the target (no rollout).
            serving_rev = target_rev = 1
        elif want_hash != stored_hash and target_rev == serving_rev:
            target_rev = serving_rev + 1
            deferred_incs.append(
                metrics.inferenceservice_rollouts_total.inc)
            self.recorder.event(
                svc, "Normal", "RolloutStarted",
                f"spec change rolls revision {serving_rev} -> {target_rev}")
        elif want_hash == stored_hash and target_rev != serving_rev:
            # Revert mid-rollout: the spec hashed back to the serving
            # revision — abandon the in-flight one (its Deployment is
            # swept below); the serving revision never stopped serving.
            target_rev = serving_rev
            self.recorder.event(
                svc, "Normal", "RolloutAbandoned",
                f"spec reverted; revision {serving_rev} keeps serving")
            self._delete_stale_deployments(ns, name, serving_rev)
        rolling = target_rev != serving_rev

        # -- pods, by revision ------------------------------------------------
        pods = self._pods_of(ns, name)
        serving_pods = self._revision_pods(pods, serving_rev)
        serving_ready = [p for p in serving_pods if pod_ready(p)]

        # -- autoscale ---------------------------------------------------------
        current = api.target_replicas_of(svc)
        if current is None:
            current = api.initial_replicas(svc)
        sample = self._scrape(svc, serving_ready)
        state = state_from_status(svc.get("status"))
        decision = decide_scale(
            current, sample, targets_from_spec(svc), state, now,
            wake_requested_at=api.wake_requested_at(svc))
        desired, reason = decision.replicas, decision.reason
        if desired > current:
            # Quota clamp: never target replicas the profile cannot pay
            # for.  ``headroom`` counts the service's own current charge
            # as free to itself, so it IS the total GPUs this service
            # may hold — total affordable width, not an increment.
            headroom = self.queue.service_headroom(
                ns, own_gpus=current * slice_spec.gpus)
            affordable = (desired if headroom == float("inf") else
                          int(max(headroom, 0.0)
                              // max(slice_spec.gpus, 1)))
            if affordable < desired:
                clamped = min(desired, max(affordable, current))
                self.recorder.event(
                    svc, "Warning", "QuotaClamped",
                    f"wanted {desired} replica(s) but namespace {ns} has "
                    f"{headroom:g} free nvidia.com/gpu GPUs; targeting "
                    f"{clamped}")
                desired = clamped
                reason = api.REASON_QUOTA_CLAMPED
        if desired != current:
            direction = ("up" if desired > current else
                         "to_zero" if desired == 0 else "down")
            deferred_incs.append(
                metrics.inferenceservice_scale_events_total.labels(
                    direction=direction).inc)
            if decision.reason == "Wake":
                deferred_incs.append(
                    metrics.inferenceservice_cold_starts_total.inc)
            self.recorder.event(
                svc, "Normal", "Scaled",
                f"{decision.reason or 'Scale'}: {current} -> {desired} "
                f"replica(s) (queue {sample.queue_depth:.1f}, "
                f"ttft_p99 {sample.ttft_p99_s if sample.ttft_p99_s is not None else '-'}, "
                f"occupancy {sample.slot_occupancy if sample.slot_occupancy is not None else '-'})")

        # -- reconcile children ------------------------------------------------
        flipped = False
        if rolling and desired == 0 and not serving_pods:
            # Rollout while Idle: nothing serves traffic, so the revision
            # flips by bookkeeping alone — the new weights warm on the
            # next wake, gated by the same readiness generate().
            flipped = True
            serving_rev = target_rev
        elif rolling:
            # The serving Deployment holds traffic at its current width;
            # the target revision warms NEXT TO it.  The serving
            # revision's POD TEMPLATE is never regenerated here — the
            # live spec already describes the NEW revision, and writing
            # it into the old Deployment would roll the serving pods
            # onto the new weights before readiness proved them (the
            # exact failure the revision gate exists to prevent).  Only
            # its width may change.
            self._resize_deployment(
                ns, self.deployment_name(name, serving_rev), desired)
            create_or_update(self.client, DEPLOYMENT,
                             self.generate_deployment(svc, target_rev,
                                                      max(desired, 1)))
            target_ready = [p for p in
                            self._revision_pods(pods, target_rev)
                            if pod_ready(p)]
            if target_ready and self._probe_ready(svc, target_ready[0]):
                flipped = True
                serving_rev = target_rev
                self.recorder.event(
                    svc, "Normal", "RolloutComplete",
                    f"revision {target_rev} passed its readiness "
                    "generate(); traffic flipped, old revision draining")
        else:
            create_or_update(self.client, DEPLOYMENT,
                             self.generate_deployment(svc, serving_rev,
                                                      desired))

        create_or_update(self.client, SERVICE,
                         self.generate_service(svc, serving_rev))
        create_or_update(self.client, VIRTUALSERVICE,
                         self.generate_virtual_service(svc))
        if flipped:
            # Old revisions drain only AFTER the Service flip landed.
            self._delete_stale_deployments(ns, name, serving_rev)

        # -- status ------------------------------------------------------------
        serving_pods = self._revision_pods(self._pods_of(ns, name),
                                           serving_rev)
        ready = sum(1 for p in serving_pods if pod_ready(p))
        if rolling and not flipped:
            phase = api.PHASE_ROLLING
        elif desired == 0:
            phase = api.PHASE_IDLE
        elif decision.reason == "Wake" or (current == 0 and desired > 0):
            phase = api.PHASE_WAKING
        elif ready >= desired:
            phase = api.PHASE_READY
        else:
            phase = api.PHASE_PENDING
        # Publish endpoint discovery for the activator: the READY
        # serving-revision replicas (post-flip, so a rollout's traffic
        # switch and the front door's view move together).  An empty
        # endpoint list is a real publication — it tells the front door
        # "cold: hold and wake", where a missing record means "no such
        # service: 404".
        self.book.publish(
            f"{ns}/{name}",
            endpoints=[self._endpoint_of(p, api.port_of(svc))
                       for p in serving_pods if pod_ready(p)],
            ttft_target_s=targets_from_spec(svc).ttft_p99_s,
            phase=phase)
        status = {
            "phase": phase,
            "replicas": desired,
            "readyReplicas": ready,
            "revision": serving_rev,
            "targetRevision": target_rev,
            "revisionHash": (want_hash if not rolling or flipped
                             else stored_hash),
            "reason": reason,
            # The scale subresource's labelSelectorPath.
            "selector": f"{api.LABEL_SERVICE_NAME}={name}",
            "conditions": [{
                "type": "Ready",
                "status": "True" if phase == api.PHASE_READY else "False",
                "reason": phase,
                "message": f"{ready}/{desired} replica(s) ready at "
                           f"revision {serving_rev}",
            }],
            **state_to_status(decision.state),
        }
        if svc.get("status") != status:
            patch_status_diff(self.client, INFERENCESERVICE, svc, status)
            for inc in deferred_incs:
                inc()
            try:
                self.queue.observe_service(
                    self.client.get(INFERENCESERVICE, name, ns))
            except errors.ApiError:
                pass
        # Always requeue: the autoscaler is a sampled loop, and rollouts/
        # wakes watch pod readiness.  Idle-at-zero still polls (cheap: no
        # pods to scrape) so the wake annotation is honored within one
        # period even if its watch delta is lost.
        return Result(requeue_after=self.sync_period)

    # -- scraping -------------------------------------------------------------

    @staticmethod
    def _revision_pods(pods: List[Resource], revision: int
                       ) -> List[Resource]:
        return [p for p in pods
                if deep_get(p, "metadata", "labels", api.LABEL_REVISION)
                == str(revision)]

    def _endpoint_of(self, pod: Resource, port: int) -> Optional[str]:
        override = deep_get(pod, "metadata", "annotations",
                            api.ANNOTATION_ENDPOINT)
        if override:
            return override.rstrip("/")
        ip = deep_get(pod, "status", "podIP")
        return f"http://{ip}:{port}" if ip else None

    def _scrape(self, svc: Resource,
                ready_pods: List[Resource]) -> ServeSample:
        """The real scrape path, on the fleet substrate: GET /metrics on
        every ready serving replica through the FleetScraper (one fetch
        hook, FlightPool fan-out, reason-classified failures), store the
        samples in the shared TSDB with service/replica labels, and
        compute the decision sample from stored series — TTFT p99 over
        the merged-bucket delta between this pass and the previous one,
        the sample ``parse_serve_pages`` gives on the same pages."""
        from kubeflow_tpu_torch.telemetry import fleetscrape

        ns, name = meta(svc)["namespace"], name_of(svc)
        key = f"{ns}/{name}"
        targets = fleetscrape.inferenceservice_targets(
            ready_pods, port=api.port_of(svc), service_key=key)
        self.fleet.scrape_service(key, targets)
        return fleetscrape.serve_sample(self.tsdb, key)

    def _probe_ready(self, svc: Resource, pod: Resource) -> bool:
        """The controller's OWN readiness generate() check before a
        traffic flip — the kubelet's probe gates the pod Ready condition,
        this gates the Service selector.  The probe round trip lands on
        the service's causal journey as a ``readiness_warm`` segment
        (the warm generate is where rollout-flip latency hides)."""
        from kubeflow_tpu_torch.telemetry import causal

        url = self._endpoint_of(pod, api.port_of(svc))
        if url is None:
            return False
        t0 = time.time()
        ok = self.scraper(url + "/readyz") is not None
        ctx = causal.current()
        if ctx is not None:
            causal.record(
                "readiness_warm", trace_id=ctx.trace_id,
                parent_span_id=ctx.span_id, segment="readiness_warm",
                start_ts=t0, end_ts=time.time(),
                object=name_of(pod), ok=ok)
        return ok

    # -- generation -----------------------------------------------------------

    @staticmethod
    def deployment_name(name: str, revision: int) -> str:
        return f"{name}-v{revision}"

    def generate_deployment(self, svc: Resource, revision: int,
                            replicas: int) -> Resource:
        """Revision ``revision``'s Deployment: ``serving_deployment`` over
        the spec, owned by the service."""
        deployment = gpu_pods.serving_deployment(
            ns=meta(svc)["namespace"], name=name_of(svc), revision=revision,
            replicas=replicas, model=api.model_of(svc),
            spec=api.gpu_slice(svc),
            image=deep_get(svc, "spec", "image") or self.image,
            port=api.port_of(svc),
            checkpoint_dir=api.checkpoint_dir_of(svc),
            quantize=deep_get(svc, "spec", "quantize"),
            mesh=deep_get(svc, "spec", "mesh"),
            max_seq_len=deep_get(svc, "spec", "maxSeqLen"))
        set_owner(deployment, svc)
        return deployment

    def generate_service(self, svc: Resource, revision: int) -> Resource:
        ns, name = meta(svc)["namespace"], name_of(svc)
        out = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": ns,
                         "labels": {api.LABEL_SERVICE_NAME: name}},
            "spec": {
                # BOTH labels: the revision selector is the rollout's
                # atomic traffic switch.
                "selector": {
                    api.LABEL_SERVICE_NAME: name,
                    api.LABEL_REVISION: str(revision),
                },
                "ports": [{"name": "http-serve", "port": 80,
                           "targetPort": api.port_of(svc)}],
            },
        }
        set_owner(out, svc)
        return out

    def generate_virtual_service(self, svc: Resource) -> Resource:
        ns, name = meta(svc)["namespace"], name_of(svc)
        vs = {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"inferenceservice-{ns}-{name}",
                         "namespace": ns},
            "spec": {
                "hosts": ["*"],
                "gateways": [self.istio_gateway],
                "http": [{
                    "match": [{"uri": {
                        "prefix": f"/serve/{ns}/{name}/"}}],
                    "rewrite": {"uri": "/"},
                    "route": [{"destination": {
                        "host": f"{name}.{ns}.svc.{self.cluster_domain}",
                        "port": {"number": 80},
                    }}],
                }],
            },
        }
        set_owner(vs, svc)
        return vs

    def _resize_deployment(self, ns: str, dep_name: str,
                           replicas: int) -> None:
        """Width-only update of a live Deployment (the mid-rollout
        serving revision): its stored pod template — the spec snapshot
        its revision was generated from — is left untouched."""
        cur = self._cached_get(DEPLOYMENT, dep_name, ns)
        if cur is None or deep_get(cur, "spec", "replicas") == replicas:
            return
        live = thaw(cur)
        live["spec"]["replicas"] = replicas
        create_or_update(self.client, DEPLOYMENT, live)

    def _delete_stale_deployments(self, ns: str, name: str,
                                  keep_revision: int) -> None:
        inf = self.informers.get(DEPLOYMENT)
        if inf is not None:
            deployments = inf.index_list("inferenceservice", f"{ns}/{name}")
        else:
            deployments = self.client.list(
                DEPLOYMENT, ns,
                label_selector={api.LABEL_SERVICE_NAME: name})
        for d in deployments:
            rev = deep_get(d, "metadata", "labels", api.LABEL_REVISION)
            if rev == str(keep_revision):
                continue
            try:
                self.client.delete(DEPLOYMENT, name_of(d), ns)
            except errors.NotFound:
                pass


# -- watch mappers / indexers -------------------------------------------------


def pods_to_service_requests(obj: Resource) -> List[Request]:
    labels = deep_get(obj, "metadata", "labels", default={}) or {}
    svc = labels.get(api.LABEL_SERVICE_NAME)
    if not svc:
        return []
    return [Request(deep_get(obj, "metadata", "namespace", default=""), svc)]


def _service_label_index(obj: Resource) -> List[str]:
    labels = deep_get(obj, "metadata", "labels", default={}) or {}
    svc = labels.get(api.LABEL_SERVICE_NAME)
    ns = deep_get(obj, "metadata", "namespace", default="")
    return [f"{ns}/{svc}"] if svc else []


def make_controller(client, **kwargs):
    from kubeflow_tpu_torch.platform.k8s.types import GPUJOB, NODE, RESOURCEQUOTA
    from kubeflow_tpu_torch.platform.runtime import Controller
    from kubeflow_tpu_torch.platform.runtime.informer import Informer

    shards = kwargs.pop("shards", None)
    informers = {
        INFERENCESERVICE: Informer(client, INFERENCESERVICE),
        DEPLOYMENT: Informer(
            client, DEPLOYMENT,
            indexers={"inferenceservice": _service_label_index}),
        POD: Informer(client, POD,
                      indexers={"inferenceservice": _service_label_index}),
        SERVICE: Informer(client, SERVICE),
    }
    # The ledger feed is UNSHARDED for the same reason the gpujob
    # controller's is: every replica must compute the same quota truth
    # for the keys it owns.  (Each controller keeps its own ledger
    # instance; both are pure functions of the same watch state.)
    queue = jq.JobQueue()
    queue.informer_backed = True
    queue_informers = {
        INFERENCESERVICE: Informer(client, INFERENCESERVICE),
        RESOURCEQUOTA: Informer(client, RESOURCEQUOTA),
        NODE: Informer(client, NODE),
    }
    queue_informers[GPUJOB] = Informer(client, GPUJOB)

    def _on_service_delta(etype, obj):
        ns = deep_get(obj, "metadata", "namespace", default="") or ""
        if etype == "DELETED":
            queue.forget_service(ns, name_of(obj))
        else:
            queue.observe_service(obj)

    def _on_job_delta(etype, obj):
        ns = deep_get(obj, "metadata", "namespace", default="") or ""
        if etype == "DELETED":
            queue.forget(ns, name_of(obj))
        else:
            queue.observe(obj)

    queue_informers[INFERENCESERVICE].add_handler(_on_service_delta)
    queue_informers[GPUJOB].add_handler(_on_job_delta)
    queue_informers[RESOURCEQUOTA].add_handler(
        lambda _e, _o: queue.set_quotas(
            queue_informers[RESOURCEQUOTA].list()))
    queue_informers[NODE].add_handler(
        lambda _e, _o: queue.set_nodes(queue_informers[NODE].list()))

    # Production wiring scrapes into the process-shared store and
    # publishes into the process-shared book the activator reads;
    # explicit tsdb= and book= override for hermetic harnesses.
    from kubeflow_tpu_torch.platform import activator as _activator
    from kubeflow_tpu_torch.telemetry import fleetscrape

    kwargs.setdefault("tsdb", fleetscrape.default_tsdb())
    kwargs.setdefault("book", _activator.default_book())
    reconciler = InferenceServiceReconciler(client, informers=informers,
                                            queue=queue, **kwargs)

    def on_start():
        metrics.register_inferenceservice_collector(client)
        for informer in queue_informers.values():
            informer.start()
        for informer in queue_informers.values():
            # Best-effort: an unsynced ledger degrades to permissive
            # headroom until the feed lands — never a startup failure.
            informer.wait_for_sync(30.0)

    def on_stop():
        metrics.register_inferenceservice_collector(None)
        for informer in queue_informers.values():
            informer.stop()

    return Controller(
        "inferenceservice-controller",
        reconciler,
        primary=INFERENCESERVICE,
        owns=[DEPLOYMENT, SERVICE, VIRTUALSERVICE],
        watches=[(POD, pods_to_service_requests)],
        informers=informers,
        on_start=on_start,
        on_stop=on_stop,
        resync_period=300.0,
        shards=shards,
    )
