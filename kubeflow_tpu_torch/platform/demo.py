"""Minimum end-to-end slice, runnable anywhere: the port's copy of
``kubeflow_tpu/platform/demo.py``.

    python -m kubeflow_tpu_torch.platform.demo [--gpu h100-80gb --gpus 8]
    python -m kubeflow_tpu_torch.platform.demo --serve

Boots the notebook controller (real watch, queue and reconcile threads)
against the in-memory API server, applies a Notebook, plays the kubelet
bringing its workers up, and prints the objects the control plane made.
``--serve`` boots the whole platform on loopback ports instead and
keeps serving until interrupted.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from kubeflow_tpu_torch.platform.controllers.notebook import make_controller
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    NOTEBOOK,
    SERVICE,
    STATEFULSET,
    deep_get,
)
from kubeflow_tpu_torch.platform.runtime import Manager
from kubeflow_tpu_torch.platform.testing.fake import FakeKube

# The spawner's default image (apps/jupyter/spawner_ui_config.json).
DEFAULT_IMAGE = "ghcr.io/kubeflow-tpu/jupyter-pytorch-cuda:latest"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--name", default="my-notebook")
    ap.add_argument("--namespace", default="alice")
    ap.add_argument("--image", default=DEFAULT_IMAGE)
    ap.add_argument("--gpu", default=None,
                    help="GPU accelerator (e.g. h100-80gb)")
    ap.add_argument("--gpus", type=int, default=None,
                    help="GPUs of the notebook (e.g. 8)")
    ap.add_argument(
        "--serve", action="store_true",
        help="boot the whole platform (controllers + webhook + web apps) "
             "against the in-memory API server and keep serving",
    )
    args = ap.parse_args(argv)
    if args.serve:
        return serve_full_platform(args)

    kube = FakeKube()
    kube.add_namespace(args.namespace)
    mgr = Manager(kube)
    mgr.add(make_controller(kube, use_istio=True))
    mgr.start()

    nb = {
        "apiVersion": "kubeflow.org/v1beta1",
        "kind": "Notebook",
        "metadata": {"name": args.name, "namespace": args.namespace},
        "spec": {"template": {"spec": {"containers": [{"image": args.image}]}}},
    }
    if args.gpu:
        nb["spec"]["gpu"] = {"accelerator": args.gpu}
        if args.gpus:
            nb["spec"]["gpu"]["gpus"] = args.gpus
    print(f"--> apply Notebook {args.namespace}/{args.name}"
          + (f" (gpu={args.gpu} gpus={args.gpus or 'default'})"
             if args.gpu else ""))
    kube.create(nb)

    sts = _wait(lambda: kube.get(STATEFULSET, args.name, args.namespace))
    replicas = deep_get(sts, "spec", "replicas")
    print(f"<-- StatefulSet created: replicas={replicas} "
          f"serviceName={deep_get(sts, 'spec', 'serviceName')}")
    pod_spec = deep_get(sts, "spec", "template", "spec")
    if pod_spec.get("nodeSelector"):
        print(f"    nodeSelector: {json.dumps(pod_spec['nodeSelector'])}")
    main_c = pod_spec["containers"][0]
    limits = deep_get(main_c, "resources", "limits", default={})
    if limits:
        print(f"    gpu limits: {json.dumps(limits)}")
    env_preview = {
        e["name"]: e.get("value", "<downward-api>") for e in main_c.get("env", [])
    }
    print(f"    env: {json.dumps(env_preview)}")

    svc = _wait(lambda: kube.get(SERVICE, args.name, args.namespace))
    print(f"<-- Service: selector={json.dumps(svc['spec']['selector'])} port 80->"
          f"{svc['spec']['ports'][0]['targetPort']}")

    # The kubelet's stand-in: every worker up, then the status converges.
    for i in range(replicas):
        kube.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": f"{args.name}-{i}", "namespace": args.namespace,
                "labels": {"statefulset": args.name, "notebook-name": args.name},
            },
        })
        kube.set_pod_phase(args.namespace, f"{args.name}-{i}", "Running", ready=True)
    print(f"--> kubelet-sim: {replicas} worker pod(s) Running+Ready")

    nb = _wait(
        lambda: (
            lambda o: o
            if deep_get(o, "status", "readyReplicas") == replicas
            else None
        )(kube.get(NOTEBOOK, args.name, args.namespace))
    )
    print(f"<-- Notebook status: readyReplicas={nb['status']['readyReplicas']}"
          f"/{nb['status']['replicas']}")
    print("OK: spawn flow complete")
    mgr.stop()
    return 0


def serve_full_platform(args) -> int:
    """Every service of the platform, live on loopback ports, backed by
    the in-memory API server: two GPU nodes, the GPU runtime's
    PodDefault, the controllers, the webhook and the five web apps."""
    import signal

    from kubeflow_tpu_torch.platform.apis.poddefault import gpu_pod_default
    from kubeflow_tpu_torch.platform.apps.jupyter.app import create_app as jwa
    from kubeflow_tpu_torch.platform.apps.tensorboards.app import create_app as twa
    from kubeflow_tpu_torch.platform.apps.volumes.app import create_app as vwa
    from kubeflow_tpu_torch.platform.controllers import culling, profile, tensorboard
    from kubeflow_tpu_torch.platform.dashboard.app import create_app as dashboard
    from kubeflow_tpu_torch.platform.kfam.app import create_app as kfam
    from kubeflow_tpu_torch.platform.webhook.server import WebhookServer

    kube = FakeKube()
    kube.add_namespace("kubeflow")
    kube.add_gpu_node("gpu-node-1", gpus=8)
    kube.add_gpu_node("gpu-node-2", gpus=8)
    # The GPU runtime's PodDefault, so the webhook path is exercisable.
    kube.create(gpu_pod_default("kubeflow", "h100-80gb", 8))

    mgr = Manager(kube)
    nb_ctrl = mgr.add(make_controller(kube, use_istio=True))
    mgr.add(profile.make_controller(kube))
    mgr.add(tensorboard.make_controller(kube))
    mgr.add(culling.make_controller(
        kube, prober=lambda url: None,
        notebook_informer=nb_ctrl.informers.get(NOTEBOOK)))
    mgr.start()

    webhook = WebhookServer(kube, host="127.0.0.1", port=0)
    webhook.start()

    servers = {}
    for name, factory in [
        ("jupyter", jwa), ("volumes", vwa), ("tensorboards", twa),
        ("kfam", kfam), ("dashboard", dashboard),
    ]:
        # Plain HTTP on loopback: secure-cookie CSRF mode would refuse
        # every mutation (a client sends no Secure cookie over HTTP).
        app = factory(kube, secure_cookies=False)
        servers[name] = app.test_server()

    # The dashboard's menu points at the apps' own ports (a deployment
    # routes path prefixes through its gateway; this one has none).
    kube.create({
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "kubeflow-dashboard-settings",
                     "namespace": "kubeflow"},
        "data": {"links": json.dumps({
            "menuLinks": [
                {"link": servers["jupyter"][1] + "/", "text": "Notebooks",
                 "icon": "book"},
                {"link": servers["volumes"][1] + "/", "text": "Volumes",
                 "icon": "device:storage"},
                {"link": servers["tensorboards"][1] + "/",
                 "text": "TensorBoards", "icon": "assessment"},
            ],
            "externalLinks": [], "quickLinks": [],
        })},
    })

    print("platform up (in-memory API server):")
    print(f"  webhook    https-less http://127.0.0.1:{webhook.port}/apply-poddefault")
    for name, (_, base) in servers.items():
        print(f"  {name:<11}{base}")
    print("identity: pass header 'kubeflow-userid: <email>'")
    print("Ctrl-C to stop", flush=True)
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass
    mgr.stop()
    webhook.stop()
    for srv, _ in servers.values():
        srv.shutdown()
    return 0


def _wait(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
        except errors.ApiError:
            pass
        time.sleep(0.05)
    print("TIMEOUT waiting for controller", file=sys.stderr)
    sys.exit(1)


if __name__ == "__main__":
    sys.exit(main())
