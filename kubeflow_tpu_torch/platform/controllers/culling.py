"""Culling controller: stop idle notebooks to release their GPUs.  The
port's copy of ``kubeflow_tpu/platform/controllers/culling.py``.

Same contract as the reference culler (reference culling_controller.go:
78-162 loop, 202-241 kernel probe, 243-255 idleness check, 179-200 window):
probe the Jupyter kernels API over cluster DNS, and when every kernel has
been idle past CULL_IDLE_TIME, set the ``kubeflow-resource-stopped``
annotation — the notebook reconciler then scales the whole slice to zero.
An idle 8-GPU notebook is 8 parked H100s.

The kernel API only exists on worker 0, and the per-notebook Service
already routes there, so the probe URL is identical for single- and
multi-host slices.

The HTTP prober is injected (tests use a fake; by default
``default_prober``, on the standard library's ``urllib.request``).
"""
from __future__ import annotations

import datetime
import json
import logging
import threading
import time
import urllib.request
from typing import Callable, List, Optional

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.apis import notebook as nbapi
from kubeflow_tpu_torch.platform.k8s.types import (
    NOTEBOOK,
    Resource,
    deep_get,
    name_of,
)
from kubeflow_tpu_torch.platform.runtime import Reconciler, Request, Result
from kubeflow_tpu_torch.platform.runtime import metrics

TIME_FORMAT = "%Y-%m-%dT%H:%M:%SZ"

# Kernel execution states that count as "busy" (probe returns Jupyter's
# /api/kernels JSON; anything not idle keeps the notebook alive).
IDLE_STATE = "idle"

Prober = Callable[[str], Optional[List[dict]]]  # url -> kernels or None on error


def default_prober(url: str, *, timeout: Optional[float] = None
                   ) -> Optional[List[dict]]:
    """HTTP probe of the Jupyter kernels API: the kernels, or None for a
    non-200 answer, a body that is not a JSON list, or any error.
    ``timeout`` is the whole per-probe budget (env
    ``CULL_PROBE_TIMEOUT_SECONDS``): a wedged user pod costs a bounded
    slice of the worker's cycle, never a hang.  It bounds the connect
    and each read, and the body is read against the same deadline.  The
    probe goes straight to the pod's Service: no proxy from the
    environment is used."""
    if timeout is None:
        timeout = config.env_float("CULL_PROBE_TIMEOUT_SECONDS", 10.0)
    deadline = time.monotonic() + timeout
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(url, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            chunks = []
            while chunk := resp.read1(1 << 16):
                chunks.append(chunk)
                if time.monotonic() > deadline:
                    return None
        data = json.loads(b"".join(chunks))
        return data if isinstance(data, list) else None
    except Exception:  # noqa: BLE001 — any failure is "no answer"
        return None


class CullingReconciler(Reconciler):
    def __init__(
        self,
        client,
        *,
        prober: Optional[Prober] = None,
        idle_minutes: Optional[float] = None,
        check_period_minutes: Optional[float] = None,
        cluster_domain: Optional[str] = None,
        now: Optional[Callable[[], datetime.datetime]] = None,
        cache=None,
        probe_timeout: Optional[float] = None,
        probe_budget_s: Optional[float] = None,
    ):
        self.client = client
        # Optional Notebook Informer (make_controller wires the same one
        # the controller watches through): reconcile then reads the
        # notebook from the shared cache as a zero-copy frozen view
        # instead of one apiserver GET per probe period per notebook.
        self.cache = cache
        self.probe_timeout = (
            probe_timeout if probe_timeout is not None
            else config.env_float("CULL_PROBE_TIMEOUT_SECONDS", 10.0)
        )
        # Per-cycle probe budget: cumulative wall seconds the reconcilers
        # may spend probing per check period (all workers combined).  Once
        # exhausted, remaining notebooks this cycle count as BUSY and are
        # re-checked next period — a fleet of wedged pods degrades culling
        # to "slower", never to "the probe loop ate the controller".
        # 0 = unlimited (the default; operators opt in).
        self.probe_budget_s = (
            probe_budget_s if probe_budget_s is not None
            else config.env_float("CULL_PROBE_BUDGET_SECONDS", 0.0)
        )
        self._budget_lock = threading.Lock()
        self._budget_window_start: Optional[float] = None
        self._budget_used = 0.0
        if prober is not None:
            self.prober = prober
        else:
            self.prober = lambda url: default_prober(
                url, timeout=self.probe_timeout)
        self.idle_minutes = (
            idle_minutes
            if idle_minutes is not None
            else config.env_float("CULL_IDLE_TIME", 1440.0)
        )
        self.check_period = (
            check_period_minutes
            if check_period_minutes is not None
            else config.env_float("IDLENESS_CHECK_PERIOD", 1.0)
        )
        self.cluster_domain = cluster_domain or config.env("CLUSTER_DOMAIN", "cluster.local")
        self.dev = config.env_bool("DEV", False)
        self._now = now or (lambda: datetime.datetime.now(datetime.timezone.utc))
        # (ns, name) -> wall-clock datetime (self._now()) of the last
        # probe — the injectable clock, so tests drive it; a backwards
        # clock step is clamped in reconcile.  The probe schedule is
        # the CHECK PERIOD, not the event rate: every
        # reconcile of a busy notebook patches the last-activity
        # annotation, whose MODIFIED delta re-enqueues the key — without
        # this throttle that loop probes the user pod at ~probe-latency
        # rate instead of once per period (review r5).  Resyncs and
        # unrelated notebook updates are throttled identically, so an
        # operator's IDLENESS_CHECK_PERIOD actually governs probe load.
        self._last_probe: dict = {}

    # -- probe url -----------------------------------------------------------

    def kernels_url(self, namespace: str, name: str) -> str:
        # Through the per-notebook Service (port 80 → worker 0), under the
        # NB_PREFIX base path the server runs with.  DEV mode reaches the
        # Service through a local kubectl proxy instead of cluster DNS
        # (reference culling_controller.go:211-216).
        prefix = nbapi.nb_prefix(namespace, name)
        if self.dev:
            port_name = nbapi.service_port_name(name)
            return (
                f"http://localhost:8001/api/v1/namespaces/{namespace}"
                f"/services/{name}:{port_name}/proxy{prefix}/api/kernels"
            )
        return (
            f"http://{name}.{namespace}.svc.{self.cluster_domain}"
            f"{prefix}/api/kernels"
        )

    # -- reconcile -----------------------------------------------------------

    def reconcile(self, req: Request) -> Optional[Result]:
        now = self._now()
        key = (req.namespace, req.name)
        last_probe_at = self._last_probe.get(key)
        period_s = self.check_period * 60.0
        if last_probe_at is not None:
            since = (now - last_probe_at).total_seconds()
            # The throttle runs BEFORE any apiserver read, or an event
            # storm still costs one GET per delta.  Negative `since` (a
            # wall-clock step backwards — these are _now() datetimes, not
            # monotonic) falls through and probes rather than extending
            # the suppression by the skew.
            if 0 <= since < period_s:
                # Probed recently: don't let watch events / resyncs turn
                # the check period into the event rate.  (A just-deleted/
                # stopped notebook's throttle entry lingers at most one
                # period before the cleanup below sees it.)
                return Result(requeue_after=period_s - since)

        requeue = Result(requeue_after=period_s)
        notebook = self._get_notebook(req.name, req.namespace)
        if notebook is None:
            self._last_probe.pop(key, None)
            return None
        if nbapi.is_stopped(notebook):
            self._last_probe.pop(key, None)
            return None  # nothing to cull; notebook reconciler handles restart

        self._last_probe[key] = now

        kernels = self._safe_probe(req.namespace, req.name)
        if kernels is None:
            # Unreachable / errored / over budget (starting, crashing,
            # mid-scale, broken prober) — FAIL SAFE: a notebook whose
            # idleness probe can't answer counts as BUSY and is never
            # culled blind.  Next period retries.
            return requeue
        if not self._all_idle(kernels):
            self._record_activity(notebook, now)
            return requeue

        last = self._last_activity(notebook, kernels)
        if last is None:
            self._record_activity(notebook, now)
            return requeue
        idle_for = (now - last).total_seconds() / 60.0
        if idle_for < self.idle_minutes:
            return requeue

        # One-annotation merge patch: the cull write touches exactly the
        # stop marker — no thaw of the frozen cache view, no full-object
        # PUT, and no resourceVersion to 409 against the notebook
        # controller's concurrent status writes.
        self.client.patch(
            NOTEBOOK, req.name,
            {"metadata": {"annotations": {
                nbapi.STOP_ANNOTATION: now.strftime(TIME_FORMAT)}}},
            req.namespace,
        )
        metrics.notebook_culling_total.inc()
        metrics.last_culling_timestamp.set(now.timestamp())
        return None

    def _safe_probe(self, namespace: str, name: str) -> Optional[List[dict]]:
        """Run the prober under the fail-safe contract: ANY exception (a
        raising prober must not crash-loop the reconcile into backoff —
        with a broken probe endpoint that loop would probe at retry rate
        forever) and an exhausted per-cycle budget both answer None, which
        reconcile treats as busy.  Probe wall time is charged against the
        budget window."""
        reserved = 0.0
        if self.probe_budget_s > 0:
            now_mono = time.monotonic()
            period_s = max(self.check_period * 60.0, 1e-9)
            with self._budget_lock:
                if (self._budget_window_start is None
                        or now_mono - self._budget_window_start >= period_s):
                    self._budget_window_start = now_mono
                    self._budget_used = 0.0
                if self._budget_used >= self.probe_budget_s:
                    metrics.culling_probe_failures_total.inc()
                    return None
                # RESERVE the worst case (the probe timeout) before
                # probing: with N concurrent workers, check-then-spend
                # accounting would let all N pass the gate while each
                # other's probes are still in flight — overshooting an
                # operator's budget by workers x timeout per window.  The
                # reservation is trued up to actual cost below.
                reserved = self.probe_timeout
                self._budget_used += reserved
        t0 = time.monotonic()
        try:
            kernels = self.prober(self.kernels_url(namespace, name))
        except Exception:
            logging.getLogger("kubeflow_tpu_torch.culling").warning(
                "idleness probe for %s/%s raised; counting as busy",
                namespace, name, exc_info=True)
            kernels = None
        finally:
            if self.probe_budget_s > 0:
                with self._budget_lock:
                    self._budget_used += (time.monotonic() - t0) - reserved
        if kernels is None:
            metrics.culling_probe_failures_total.inc()
        return kernels

    def _get_notebook(self, name: str, namespace: str) -> Optional[Resource]:
        """Frozen cache read when the shared informer is wired and synced
        (the probe throttle already makes this path freshness-tolerant);
        live GET otherwise.  None when the notebook is gone."""
        from kubeflow_tpu_torch.platform.runtime.informer import (
            cache_or_client_get,
        )

        return cache_or_client_get(self.cache, self.client, NOTEBOOK,
                                   name, namespace)

    # -- idleness ------------------------------------------------------------

    @staticmethod
    def _all_idle(kernels: List[dict]) -> bool:
        return all(k.get("execution_state") == IDLE_STATE for k in kernels)

    def _last_activity(self, notebook: Resource, kernels: List[dict]):
        """Most recent activity across kernels; falls back to the annotation
        (kernel-less servers still get culled from their last known touch)."""
        stamps = []
        for k in kernels:
            ts = _parse_time(k.get("last_activity"))
            if ts:
                stamps.append(ts)
        ann = _parse_time(
            (deep_get(notebook, "metadata", "annotations", default={}) or {}).get(
                nbapi.LAST_ACTIVITY_ANNOTATION
            )
        )
        if ann:
            stamps.append(ann)
        return max(stamps) if stamps else None

    def _record_activity(self, notebook: Resource, now) -> None:
        annotations = deep_get(notebook, "metadata", "annotations", default={}) or {}
        stamp = now.strftime(TIME_FORMAT)
        if annotations.get(nbapi.LAST_ACTIVITY_ANNOTATION) == stamp:
            return
        self.client.patch(
            NOTEBOOK,
            name_of(notebook),
            {"metadata": {"annotations": {nbapi.LAST_ACTIVITY_ANNOTATION: stamp}}},
            deep_get(notebook, "metadata", "namespace"),
        )


def _parse_time(value: Optional[str]):
    if not value:
        return None
    for fmt in (TIME_FORMAT, "%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%S.%f%z",
                "%Y-%m-%dT%H:%M:%S%z"):
        try:
            dt = datetime.datetime.strptime(value, fmt)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=datetime.timezone.utc)
            return dt
        except ValueError:
            continue
    return None


def make_controller(client, *, notebook_informer=None, **kwargs):
    from kubeflow_tpu_torch.platform.runtime import Controller
    from kubeflow_tpu_torch.platform.runtime.informer import Informer

    # Sharded HA: the coordinator belongs to the Controller, which
    # filters the (owned) informer and fences every probe-driven write.
    shards = kwargs.pop("shards", None)
    # The reconciler reads notebooks from the SAME cache the controller
    # watches through (owned or shared) — zero-copy frozen views instead
    # of one apiserver GET per probe.
    owned = (Informer(client, NOTEBOOK)
             if notebook_informer is None else None)
    kwargs.setdefault("cache", notebook_informer
                      if notebook_informer is not None else owned)
    reconciler = CullingReconciler(client, **kwargs)
    return Controller(
        "culling-controller",
        reconciler,
        primary=NOTEBOOK,
        # Informer-sourced like the notebook controller: a raw watch
        # re-listed every notebook as ADDED on each bounded-window
        # rollover, and for THIS controller every spurious reconcile is
        # an HTTP probe into a user pod.  ``notebook_informer`` lets the
        # manager process SHARE the notebook controller's informer (one
        # LIST+WATCH stream and one cache for the kind — the
        # controller-runtime shared-cache model; Informer.start is
        # idempotent for exactly this).  The reconciler's per-key probe
        # throttle keeps the probe rate at the check period regardless
        # of delta rate.
        # Explicit None check: Informer defines __len__, so an EMPTY
        # shared informer is falsy and `or` would silently discard it.
        # A passed-in informer goes in shared_informers — this controller
        # must never stop the notebook controller's cache.
        informers=(None if notebook_informer is not None
                   else {NOTEBOOK: owned}),
        shared_informers=({NOTEBOOK: notebook_informer}
                          if notebook_informer is not None else None),
        # The resync re-seeds parked requeues after a restart; it runs at
        # the operator's check period (not a hardcoded faster one, which
        # silently overrode IDLENESS_CHECK_PERIOD > 1 min) and reads the
        # informer cache, not the apiserver.
        resync_period=max(60.0, reconciler.check_period * 60.0),
        # Probes are blocking I/O (default_prober timeout 10 s): with one
        # worker a single unreachable notebook stalls every other
        # notebook's idleness check for the whole timeout, and a fleet of
        # N notebooks needs N sequential probes per check period.  Eight
        # workers probe concurrently; the workqueue's per-key exclusion
        # keeps the single-reconciler-per-notebook guarantee.
        workers=8,
        shards=shards,
    )
