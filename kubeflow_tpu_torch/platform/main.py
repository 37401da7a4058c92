"""Production entrypoint: run any platform service against a cluster.  The
port's copy of ``kubeflow_tpu/platform/main.py``, on the standard
library (``wsgiref`` and the port's ``web/framework.py``; no werkzeug).

    python -m kubeflow_tpu_torch.platform.main controllers   # reconcilers + health port
    python -m kubeflow_tpu_torch.platform.main webhook       # PodDefault admission (TLS)
    python -m kubeflow_tpu_torch.platform.main jupyter|volumes|tensorboards|kfam|dashboard

Config comes from the environment: the in-cluster service account, or a
JSON kubeconfig at ``$KUBECONFIG`` (``k8s/client.py``); a missing or bad
one ends the process with an error.  The knobs are the reference
binaries' (USE_ISTIO, ENABLE_CULLING, CULL_IDLE_TIME, USERID_HEADER,
...), each read through ``config.knob`` so ``/debug/knobs`` lists them.

Write-path parallelism: ``CONTROLLER_WORKERS`` (default 4) sets
reconcile workers per controller, ``CONTROLLER_WORKERS_<NAME>`` pins
one, ``CONTROLLER_FLIGHT_POOL_SIZE`` bounds the shared fan-out pool, and
``K8S_CLIENT_POOL_SIZE`` sizes the REST client's connection pool.
"""
from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
from urllib.parse import parse_qs

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.web.framework import wsgi_server


def _client():
    from kubeflow_tpu_torch.platform.k8s.client import RestKubeClient

    return RestKubeClient()


# The /debug/ index: one line per live debug surface, so an operator
# landing on the health port finds the whole family.
DEBUG_INDEX = {
    "/debug/knobs": "effective env-knob registry (value/default/"
                    "source, secrets redacted)",
    "/debug/queue": "GPUJob gang admission ledger (waiting order, "
                    "allocations, pool/quota tallies, preemption "
                    "targets)",
    "/debug/shards": "shard-lease ownership map (sharded HA)",
    "/debug/traces": "recent reconcile span trees (?n=, ?trace_id=, "
                     "?controller=)",
    "/debug/journey/<trace_id>": "causal spans of one object journey "
                                 "(fleet-joinable)",
    "/debug/alerts": "burn-rate SLO alert states + live burn rates",
    "/debug/goodput": "per-profile GPU-second goodput decomposition "
                      "(goodput/queued/restarting/idle)",
    "/debug/profile": "always-on sampling profiler: folded stacks "
                      "per role (?window=, ?list=1, ?diff=w1,w2, "
                      "?seconds=N on-demand capture)",
    "/debug/incidents": "incident flight-recorder bundles captured "
                        "on alert firing (manifest list; fetch one "
                        "at /debug/incidents/<id>)",
    "/debug/activator": "serving front door: endpoint book + live "
                        "per-tenant hold queues (docs/serving.md "
                        "\"The front door\")",
}


def _profile_body(prof, qs):
    """/debug/profile's answer: (content type, body) or None for 404."""
    if "list" in qs:
        return "application/json", json.dumps({
            "windows": prof.windows(),
            "hz": prof.hz,
            "windowSeconds": prof.window_seconds,
            "errors": prof.errors,
            "samplerCpuSeconds": round(prof.sampler_cpu_seconds, 4),
        })
    try:
        if "diff" in qs:
            w1, w2 = (int(w) for w in qs["diff"][0].split(",", 1))
            body = prof.diff(w1, w2)
        elif "seconds" in qs:
            body = prof.capture(float(qs["seconds"][0]))
        elif "window" in qs:
            body = prof.folded(int(qs["window"][0]))
        else:
            body = prof.folded()
    except ValueError:
        body = None
    return None if body is None else ("text/plain", body)


def health_app(manager, *, debug_traces: bool = None, client=None,
               shards=None):
    """The controllers' health port as a WSGI callable: /healthz,
    /metrics and the /debug/ family (``DEBUG_INDEX``).

    ``client``: when it exposes ``health()`` (``RestKubeClient``),
    /healthz carries the client's circuit state and consecutive
    transient failures; an open circuit does not flip /healthz to 503
    (a restart would not fix an unreachable API server, it would only
    lose the informer caches).  The port is unauthenticated (probes and
    Prometheus need it), so ``DEBUG_TRACES=false`` answers 404 for the
    traces, journeys and profiles.  A debug page whose source is not
    registered in this process answers 404."""
    if debug_traces is None:
        debug_traces = config.env_bool("DEBUG_TRACES", True)

    def debug_json(path, qs):
        """The JSON body of a /debug/ page, or None for 404."""
        from kubeflow_tpu_torch.platform import activator as activator_mod
        from kubeflow_tpu_torch.platform.runtime import jobqueue, trace
        from kubeflow_tpu_torch.telemetry import causal, goodput, slo
        from kubeflow_tpu_torch.telemetry import incidents as incidents_mod
        from kubeflow_tpu_torch.telemetry.serve import filter_traces

        if path in ("/debug", "/debug/"):
            return {"debug": DEBUG_INDEX}
        if path == "/debug/shards" and shards is not None:
            return {
                "identity": shards.identity,
                "num_shards": shards.num_shards,
                "owned": sorted(shards.owned()),
                "shards": {str(k): v
                           for k, v in sorted(shards.shard_map().items())},
            }
        if path == "/debug/queue":
            return jobqueue.debug_snapshot()
        if path == "/debug/alerts":
            return slo.debug_snapshot()
        if path == "/debug/goodput":
            return goodput.debug_snapshot()
        if path == "/debug/activator":
            return activator_mod.debug_snapshot()
        if path == "/debug/knobs":
            return {"knobs": config.effective()}
        if path.startswith("/debug/journey/") and debug_traces:
            trace_id = path[len("/debug/journey/"):]
            return {"trace_id": trace_id, "spans": causal.journey(trace_id)}
        if path == "/debug/incidents":
            return incidents_mod.debug_snapshot()
        if path.startswith("/debug/incidents/"):
            return incidents_mod.debug_get(path[len("/debug/incidents/"):])
        if path == "/debug/traces" and debug_traces:
            try:
                n = int(qs["n"][0]) if "n" in qs else None
            except (ValueError, IndexError):
                n = None
            return {"traces": filter_traces(
                trace.recent(None), n=n,
                trace_id=(qs.get("trace_id") or [None])[0],
                controller=(qs.get("controller") or [None])[0])}
        return None

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "")
        qs = parse_qs(environ.get("QUERY_STRING", ""))
        if path == "/healthz":
            from kubeflow_tpu_torch.platform import native

            ok = manager.healthy()
            # The wire and patch engine this replica runs on: a fleet on
            # the Python fallback decodes every watch event slower, and
            # the engine string (with the build or load failure, if any)
            # makes that a one-probe diagnosis.
            body = {"healthy": ok, "engine": native.backend_info()}
            err = native.load_error()
            if err is not None:
                body["engine_error"] = err
            if client is not None and hasattr(client, "health"):
                body["rest_client"] = client.health()
            start_response("200 OK" if ok else "503 Service Unavailable",
                           [("Content-Type", "application/json")])
            return [json.dumps(body).encode()]
        if path == "/metrics":
            from kubeflow_tpu_torch.platform.runtime import metrics

            start_response("200 OK",
                           [("Content-Type", "text/plain; version=0.0.4")])
            return [metrics.render().encode()]
        if path == "/debug/profile" and debug_traces:
            from kubeflow_tpu_torch.telemetry import profiler as profiler_mod

            prof = profiler_mod.debug_profiler()
            answer = _profile_body(prof, qs) if prof is not None else None
            if answer is not None:
                start_response("200 OK", [("Content-Type", answer[0])])
                return [answer[1].encode()]
        elif path.startswith("/debug"):
            snap = debug_json(path, qs)
            if snap is not None:
                start_response("200 OK",
                               [("Content-Type", "application/json")])
                return [json.dumps(snap).encode()]
        start_response("404 Not Found", [("Content-Type", "text/plain")])
        return [b"not found"]

    return app


def _serve_health(manager, port: int, *, host: str = "0.0.0.0",
                  debug_traces: bool = None, client=None, shards=None):
    """Serve ``health_app`` on a thread; returns the server (a test
    binds port 0 and shuts it down)."""
    server = wsgi_server(health_app(manager, debug_traces=debug_traces,
                                    client=client, shards=shards),
                         host, port)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="health-http").start()
    return server


def run_controllers(args) -> int:
    from kubeflow_tpu_torch.platform.controllers import (
        culling,
        gpujob,
        inferenceservice,
        profile,
        tensorboard,
    )
    from kubeflow_tpu_torch.platform.controllers.notebook import make_controller
    from kubeflow_tpu_torch.platform.runtime import Manager

    client = _client()
    # Sharded HA: CONTROLLER_SHARDS > 0 partitions the reconcile keyspace
    # across every replica running with the same setting; each replica
    # lease-owns a fair share of the shards, filters its caches to them
    # and fences its writes (FencedClient), so a stale replica never
    # writes a key a survivor absorbed.  It replaces LEADER_ELECT.
    num_shards = config.env_int("CONTROLLER_SHARDS", 0)
    shards = None
    ctrl_client = client
    if num_shards > 0:
        from kubeflow_tpu_torch.platform.runtime.sharding import (
            FencedClient,
            ShardCoordinator,
        )

        shards = ShardCoordinator(
            client,  # lease traffic is never fenced: the raw client
            num_shards=num_shards,
            namespace=config.env("POD_NAMESPACE", "kubeflow"),
            identity=config.env("POD_NAME", "") or None,
        )
        ctrl_client = FencedClient(client, shards)
    mgr = Manager(
        ctrl_client,
        # The reference's --leader-elect flag (main.go:64-76); ignored
        # when sharding is on.
        leader_election=(config.env_bool("LEADER_ELECT", False)
                         and shards is None),
        lease_namespace=config.env("POD_NAMESPACE", "kubeflow"),
        shards=shards,
    )
    nb_ctrl = mgr.add(
        make_controller(ctrl_client, shards=shards,
                        use_istio=config.env_bool("USE_ISTIO", True)))
    mgr.add(profile.make_controller(
        ctrl_client,
        heartbeat=True,
        shards=shards,
        default_namespace_labels_path=(
            config.env("NAMESPACE_LABELS_PATH", "") or None
        ),
    ))
    mgr.add(tensorboard.make_controller(ctrl_client, shards=shards))
    mgr.add(gpujob.make_controller(ctrl_client, shards=shards))
    mgr.add(inferenceservice.make_controller(ctrl_client, shards=shards))
    if config.env_bool("ENABLE_CULLING", False):
        from kubeflow_tpu_torch.platform.k8s.types import NOTEBOOK

        # The culler shares the notebook controller's Notebook informer.
        mgr.add(culling.make_controller(
            ctrl_client, shards=shards,
            notebook_informer=nb_ctrl.informers.get(NOTEBOOK)))
    mgr.start()
    health = _serve_health(mgr, args.health_port, client=client,
                           shards=shards)
    # The serving front door shares this process with the
    # InferenceService reconciler, which publishes ready endpoints into
    # the in-memory EndpointBook.  Wake stamps go through the raw client.
    from kubeflow_tpu_torch.platform import activator as activator_mod

    act_server = None
    act_port = activator_mod.activator_port()
    if act_port:
        act = activator_mod.Activator(client)
        activator_mod.register_debug(act)
        act_server = activator_mod.create_activator_app(act).make_server(
            "0.0.0.0", act_port)
        threading.Thread(target=act_server.serve_forever, daemon=True,
                         name="activator-http").start()
        logging.info("activator front door on :%d", act_port)
    # The fleet metrics pipeline: scrape -> in-process TSDB -> burn-rate
    # SLO rules + goodput, on one knobbed cadence.  Targets: this
    # replica's own registry and any KFT_SCRAPE_PEERS; the
    # InferenceService reconciler writes its replica scrapes into the
    # same shared TSDB.  Alert Events go through the raw client.
    from kubeflow_tpu_torch.platform.runtime import metrics as runtime_metrics
    from kubeflow_tpu_torch.telemetry import fleetscrape as fleetscrape_mod
    from kubeflow_tpu_torch.telemetry import goodput as goodput_mod
    from kubeflow_tpu_torch.telemetry import incidents as incidents_mod
    from kubeflow_tpu_torch.telemetry import profiler as profiler_mod
    from kubeflow_tpu_torch.telemetry import slo as slo_mod

    profiler = None
    if config.knob("KFT_PROFILE_ENABLED", True, config.parse_bool,
                   doc="run the always-on sampling profiler"):
        profiler = profiler_mod.Profiler()
        profiler.start()
        profiler_mod.register_debug_profiler(profiler)
    pipeline = fleetscrape_mod.MetricsPipeline(client=client)
    pipeline.scraper.add_source(lambda: [fleetscrape_mod.self_target(
        runtime_metrics.render,
        labels={"replica": config.env("POD_NAME", "") or "self"})])
    pipeline.scraper.add_source(fleetscrape_mod.peer_targets)
    slo_mod.register_debug_alerts(pipeline.engine)
    goodput_mod.register_debug_goodput(pipeline.goodput)
    if pipeline.incidents is not None:
        if shards is not None:
            pipeline.incidents.add_section(
                "shards", lambda: {
                    "identity": shards.identity,
                    "num_shards": shards.num_shards,
                    "owned": sorted(shards.owned()),
                })
        incidents_mod.register_debug_incidents(pipeline.incidents)
    pipeline.start()
    from kubeflow_tpu_torch.platform.runtime.flight import shared_pool

    logging.info(
        "controllers running (health on :%d; workers: %s; "
        "flight pool %d; client pool %d; shards %s)",
        health.server_port,
        ", ".join(f"{c.name}={c.workers}" for c in mgr.controllers),
        shared_pool().size,
        getattr(client, "pool_size", 0),
        f"{num_shards} as {shards.identity}" if shards is not None
        else "off",
    )
    _wait_for_term()
    if act_server is not None:
        act_server.shutdown()
        activator_mod.register_debug(None)
    pipeline.stop()
    slo_mod.register_debug_alerts(None)
    goodput_mod.register_debug_goodput(None)
    incidents_mod.register_debug_incidents(None)
    if profiler is not None:
        profiler.stop()
        profiler_mod.register_debug_profiler(None)
    mgr.stop()
    health.shutdown()
    return 0


def run_webhook(args) -> int:
    from kubeflow_tpu_torch.platform.webhook.server import WebhookServer

    client = _client()
    server = WebhookServer(
        client,
        host="0.0.0.0",
        port=int(config.env("WEBHOOK_PORT", "4443")),
        cert_file=config.env("TLS_CERT_FILE"),
        key_file=config.env("TLS_KEY_FILE"),
    )
    server.start()
    logging.info("webhook serving on :%d", server.port)
    _wait_for_term()
    server.stop()
    return 0


# Kinds each web app reads hot (tables, pickers, quota pre-flight):
# APP_USE_INFORMERS=true (default) serves these from shared informer
# caches, one LIST+WATCH per kind instead of a LIST per request.  The
# informers are cluster-wide, so only bounded, low-churn kinds belong
# here; pods and events stay on the live client.
_WEB_APP_CACHED_KINDS = {
    "jupyter": ("NOTEBOOK", "PVC", "PODDEFAULT", "RESOURCEQUOTA", "NODE"),
    "volumes": ("PVC", "STORAGECLASS"),
    "tensorboards": ("TENSORBOARD", "PVC", "PODDEFAULT"),
}


def _web_app_caches(client, name: str):
    import time

    from kubeflow_tpu_torch.platform.k8s import types as k8s_types
    from kubeflow_tpu_torch.platform.runtime.informer import Informer

    caches = {}
    for kind_name in _WEB_APP_CACHED_KINDS.get(name, ()):
        gvk = getattr(k8s_types, kind_name)
        caches[gvk] = Informer(client, gvk, resync_period=3600.0).start()
    # Warm up under one shared deadline: an unsynced cache only means
    # live-client reads until it lands (the backend checks has_synced per
    # read), so a slow API server must not stack a timeout per kind in
    # front of the bind.
    deadline = time.monotonic() + 10.0
    for informer in caches.values():
        informer.wait_for_sync(max(0.0, deadline - time.monotonic()))
    return caches


_WEB_APPS = {
    "jupyter": "kubeflow_tpu_torch.platform.apps.jupyter.app",
    "volumes": "kubeflow_tpu_torch.platform.apps.volumes.app",
    "tensorboards": "kubeflow_tpu_torch.platform.apps.tensorboards.app",
    "kfam": "kubeflow_tpu_torch.platform.kfam.app",
    "dashboard": "kubeflow_tpu_torch.platform.dashboard.app",
}


def run_web_app(name: str, args) -> int:
    import importlib

    module = importlib.import_module(_WEB_APPS[name])
    kwargs = {}
    if name == "dashboard":
        # The utilization panel: PROMETHEUS_URL names any Prometheus.
        prom = config.env("PROMETHEUS_URL", "")
        if prom:
            from kubeflow_tpu_torch.platform.dashboard.metrics_service import (
                PrometheusMetricsService,
            )

            kwargs["metrics_service"] = PrometheusMetricsService(prom)
    if name == "kfam":
        kwargs["heartbeat"] = True
        kwargs["use_informer"] = True
    client = _client()
    if name in _WEB_APP_CACHED_KINDS and config.env_bool(
            "APP_USE_INFORMERS", True):
        kwargs["caches"] = _web_app_caches(client, name)
    server = module.create_app(client, **kwargs).make_server(
        "0.0.0.0", args.port)
    logging.info("%s serving on :%d", name, server.server_port)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=f"{name}-http").start()
    _wait_for_term()
    server.shutdown()
    return 0


def _wait_for_term() -> None:
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()


SERVICES = ("controllers", "webhook", "jupyter", "volumes", "tensorboards",
            "kfam", "dashboard")


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("service", choices=SERVICES)
    ap.add_argument("--port", type=int, default=int(config.env("PORT", "5000")))
    ap.add_argument("--health-port", type=int,
                    default=int(config.env("HEALTH_PORT", "8080")))
    args = ap.parse_args(argv)

    if args.service == "controllers":
        return run_controllers(args)
    if args.service == "webhook":
        return run_webhook(args)
    return run_web_app(args.service, args)


if __name__ == "__main__":
    sys.exit(main())
