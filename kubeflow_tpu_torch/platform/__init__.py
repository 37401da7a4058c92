"""The platform on NVIDIA GPUs: the port's copy of the notebook control
plane, the culler, the job path, the serving front door, the user's
front door (the web apps, KFAM and the profile and tensorboard
controllers) and the controller runtime that drives them of
``kubeflow_tpu/platform/``, and the GPU seams their pods are made of.

* ``gpu/``: the accelerator table and slice math (``topology.py``) and
  the pod pieces of a notebook, a job's worker and a serving replica
  (``pods.py``);
* ``k8s/``: unstructured objects and the GVK table (``types.py``), the
  API's errors (``errors.py``), the quota math with its admission check
  (``quota.py``), the wire codec with its lazy watch objects
  (``codec.py``) and ``RestKubeClient`` with its retries, circuit
  breaker and connection pool on ``http.client`` (``client.py``);
* ``native.py`` over ``csrc/``: the native engine (the JSON and merge
  patch, the work queue, the packer and the wire scanner), built with
  ``g++`` into ``build/native/`` on first use;
* ``apis/``: the Notebook, GPUJob and InferenceService CRDs with
  ``spec.gpu``, and the PodDefault CRD;
* ``controllers/notebook.py``: ``NotebookReconciler``, a Notebook into
  its StatefulSets, Services, PDB and VirtualService;
* ``controllers/culling.py``: ``CullingReconciler``, which probes an
  idle notebook's kernels and stops it to free its GPUs;
* ``controllers/gpujob.py``: ``GPUJobReconciler``, a GPUJob into a gang
  of StatefulSets behind a headless Service, admitted, preempted and
  resumed by the queue ledger (``runtime/jobqueue.py`` ``JobQueue``);
* ``controllers/inferenceservice.py``: ``InferenceServiceReconciler``,
  a served model into per-revision GPU Deployments behind a Service,
  rolled by revision hash and autoscaled from its replicas' scraped
  telemetry (``runtime/autoscale.py``, ``telemetry/fleetscrape.py``
  into ``telemetry/tsdb.py``), to zero and back;
* ``activator.py``: the serving front door, which holds a request to a
  parked service, stamps its wake and replays it into the woken
  replica, with per-tenant admission and fair-share drain;
* ``controllers/profile.py``: ``ProfileReconciler``, a Profile into its
  namespace, RBAC, AuthorizationPolicy and ``kf-resource-quota`` (where
  ``nvidia.com/gpu`` quotas live); ``controllers/tensorboard.py``:
  ``TensorboardReconciler``, a Tensorboard into its Deployment, Service
  and VirtualService;
* ``web/``: a WSGI framework on the standard library (``framework.py``,
  served on ``wsgiref``), the CRUD backends' authn, authz, CSRF and
  probes (``crud_backend.py``), the SPAs' static files
  (``static_serving.py``), and the serving app and wire client of the
  /v1/generate contract that the model server and the activator share
  (``serve_app.py``, ``generate_client.py``: no torch, so neither is
  the controllers process's); ``apps/``: the Jupyter web app with its GPU
  picker (``apps/jupyter/``, its config ``spawner_ui_config.json``), the
  volumes and tensorboards apps; ``kfam/``: contributor bindings and
  profiles over REST; ``frontend/``: the SPAs;
* ``webhook/``: the PodDefault merge and its AdmissionReview with a
  JSON patch, served over HTTPS with live cert rotation
  (``server.py``, ``certs.py``);
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
  churned; ``testing/httpkube.py``: ``HttpKubeServer``, a ``FakeKube``
  served over HTTP, and ``make_transport``; ``testing/servesim.py``:
  ``InferenceFleetSim``, the pods of an InferenceService's Deployments;
* ``config.py``: the platform's env knobs and their registry
  (``knob``, ``effective``);
* ``dashboard/``: the central dashboard's backend with its GPU overview
  (``app.py``) and its Prometheus utilization series
  (``metrics_service.py``), beside the SPA in ``frontend/dashboard/``;
* ``main.py``: the production entrypoint, one service a process
  (``python -m kubeflow_tpu_torch.platform.main controllers|webhook|
  jupyter|volumes|tensorboards|kfam|dashboard``): the controllers with
  the activator, the fleet metrics pipeline (``telemetry/
  fleetscrape.MetricsPipeline`` over the SLO rules, goodput and the
  incident recorder) and the profiler behind one health port;
  ``demo.py``: a notebook's spawn on ``FakeKube``, or with ``--serve``
  the whole platform on loopback ports.

Standard library only (with the port's ``parallel/envspec.py`` and
``telemetry/``, and ``g++`` for the engine, whose absence leaves the
Python engines serving).  Drive it on the CPU: one leader-elected ``Manager``
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

Over the wire, the same controllers run against a ``FakeKube`` served
over HTTP (or an API server through ``RestKubeClient()``)::

    client, server = make_transport(kube, "http")
    mgr = Manager(client, leader_election=True)
    mgr.add(notebook_controller(client, use_istio=False))
    mgr.start(); ...; mgr.stop(); server.stop()

The user's front door: a Profile's reconcile makes the workspace, KFAM
binds a contributor, and the Jupyter web app spawns a notebook inside
the Profile's GPU quota::

    mgr.add(profile_controller(kube))
    kfam = create_kfam_app(kube).make_server("127.0.0.1", 0)
    jwa = create_jupyter_app(kube).make_server("127.0.0.1", 0)
    # POST /kfam/v1/bindings, then POST /api/namespaces/<ns>/notebooks
    # with {"name", "gpus": {"accelerator", "gpus"}} as the contributor

The serving front door: the controller publishes ready endpoints into
the book the activator reads, and the sim plays the Deployments' pods::

    book, tsdb = EndpointBook(), TSDB()
    mgr.add(inferenceservice_controller(kube, book=book, tsdb=tsdb))
    sim = InferenceFleetSim(kube, "ns", endpoint_for=url_of)
    act = Activator(kube, book=book, tsdb=tsdb)
    server = create_activator_app(act).make_server("127.0.0.1", 0)

A reconciler also runs bare on a client::

    NotebookReconciler(kube, use_istio=True).reconcile(Request("ns", name))

and a GPUJob's pods (``spec.gpu {accelerator, gpus, slices,
minSlices}``) run under the kubelet's stand-in::

    sim = GpuJobGangSim(kube, "ns", work=train)   # pods, then train()
    GPUJobReconciler(kube).reconcile(Request("ns", job))
"""

import importlib

# The exports load on first use (PEP 562; a module is named with None): a module that needs one piece
# of the platform, such as the data layer's packer reaching the native
# engine, imports that piece alone and not the whole control plane.
_EXPORTS = {
    "Activator": "activator",
    "CircuitBreaker": "k8s.client",
    "Controller": "runtime.controller",
    "CullingReconciler": "controllers.culling",
    "EndpointBook": "activator",
    "Interval": "dashboard.metrics_service",
    "FakeKube": "testing.fake",
    "FencedClient": "runtime.sharding",
    "FencingError": "runtime.sharding",
    "GPUJobReconciler": "controllers.gpujob",
    "GpuJobGangSim": "testing.jobsim",
    "HttpKubeServer": "testing.httpkube",
    "InferenceFleetSim": "testing.servesim",
    "InferenceServiceReconciler": "controllers.inferenceservice",
    "Informer": "runtime.informer",
    "JobQueue": "runtime.jobqueue",
    "LeaderElector": "runtime.leader",
    "MetricsService": "dashboard.metrics_service",
    "Manager": "runtime.controller",
    "NotebookReconciler": "controllers.notebook",
    "PrometheusMetricsService": "dashboard.metrics_service",
    "ProfileReconciler": "controllers.profile",
    "Request": "runtime.controller",
    "RestKubeClient": "k8s.client",
    "ShardCoordinator": "runtime.sharding",
    "ShardFilter": "runtime.sharding",
    "ShardedFleet": "testing.shardfleet",
    "TensorboardReconciler": "controllers.tensorboard",
    "WebhookApp": "webhook.server",
    "WebhookServer": "webhook.server",
    "codec": ("k8s.codec", None),
    "create_activator_app": "activator",
    "create_dashboard_app": ("dashboard.app", "create_app"),
    "create_jupyter_app": ("apps.jupyter.app", "create_app"),
    "create_kfam_app": ("kfam.app", "create_app"),
    "create_tensorboards_app": ("apps.tensorboards.app", "create_app"),
    "culling_controller": ("controllers.culling", "make_controller"),
    "default_prober": "controllers.culling",
    "demo": ("demo", None),
    "gpu_pod_default": "apis.poddefault",
    "gpujob_controller": ("controllers.gpujob", "make_controller"),
    "inferenceservice_controller": ("controllers.inferenceservice",
                                    "make_controller"),
    "effective_knobs": ("config", "effective"),
    "knob": "config",
    "main": ("main", None),
    "make_transport": "testing.httpkube",
    "mutate_admission_review": "webhook.mutate",
    "native": ("native", None),
    "notebook_controller": ("controllers.notebook", "make_controller"),
    "profile_controller": ("controllers.profile", "make_controller"),
    "shard_of": "runtime.sharding",
    "tensorboard_controller": ("controllers.tensorboard", "make_controller"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    where = _EXPORTS.get(name)
    if where is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = where if isinstance(where, tuple) else (where, name)
    mod = importlib.import_module(f"{__name__}.{module}")
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
