"""Spawner form → Notebook CR assembly.

The port's copy of ``kubeflow_tpu/platform/apps/jupyter/form.py``.  The
reference's form setters (reference jupyter/backend/apps/common/form.py:
16-276) write GPU limits into the pod template; here the device block
becomes the Notebook's first-class ``spec.gpu {accelerator, gpus,
slices}``, validated through ``gpu/topology.py`` ``slice_spec``, and the
reconciler owns all scheduling consequences — the form never touches
limits or node selectors.

The admin's config is ``spawner_ui_config.json``, the reference's
spawner config in JSON (the card's machine has no YAML parser), mounted
over ``SPAWNER_CONFIG``.  Its ``gpus`` block takes the place of
the reference's ``tpus``: ``value`` (``accelerator: none`` is a CPU
notebook), ``options`` (``[{accelerator, gpus: [counts]}]``, the
accelerators of ``gpu/topology.py`` ``ACCELERATORS`` and the GPU counts
the form offers) and ``maxSlices`` (0 or absent: one slice only).

readOnly enforcement matches the reference get_form_value (:16-60): a
readOnly field always takes the admin-configured value.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional

from kubeflow_tpu_torch.platform import config as platform_config
from kubeflow_tpu_torch.platform.gpu import ACCELERATORS, slice_spec
from kubeflow_tpu_torch.platform.web.framework import HttpError

CONFIG_PATH = os.path.join(os.path.dirname(__file__), "spawner_ui_config.json")

# mtime-keyed cache: the config is a mounted ConfigMap that changes rarely
# but must hot-reload when it does (the reference re-reads per request,
# form.py:127; this keeps that behavior without re-parsing every request).
_cache: Dict[str, tuple] = {}


def load_spawner_config(path: Optional[str] = None) -> Dict[str, Any]:
    resolved = path or platform_config.knob(
        "SPAWNER_CONFIG", CONFIG_PATH,
        doc="spawner UI config JSON (mounted ConfigMap)")
    try:
        mtime = os.stat(resolved).st_mtime
    except OSError:
        mtime = None
    cached = _cache.get(resolved)
    if cached and cached[0] == mtime:
        return cached[1]
    with open(resolved) as f:
        config = json.load(f)["spawnerFormDefaults"]
    _cache[resolved] = (mtime, config)
    return config


def get_form_value(body: dict, defaults: dict, field: str, *, body_field: str = None):
    cfg = defaults.get(field, {}) or {}
    if cfg.get("readOnly", False):
        return cfg.get("value")
    return body.get(body_field or field, cfg.get("value"))


def notebook_template(name: str, namespace: str) -> dict:
    """The SSoT template every spawned CR starts from (reference
    notebook_template:1-24)."""
    return {
        "apiVersion": "kubeflow.org/v1beta1",
        "kind": "Notebook",
        "metadata": {"name": name, "namespace": namespace, "labels": {},
                     "annotations": {}},
        "spec": {
            "template": {
                "spec": {
                    "serviceAccountName": "default-editor",
                    "containers": [{
                        "name": name,
                        "image": "",
                        "env": [],
                        "volumeMounts": [],
                        "resources": {"requests": {}, "limits": {}},
                    }],
                    "volumes": [],
                }
            }
        },
    }


def build_notebook(body: dict, defaults: dict) -> tuple[dict, List[dict]]:
    """(notebook CR, PVCs to create) from the POST body + admin defaults."""
    name = body.get("name", "")
    namespace = body.get("namespace", "")
    if not name or not namespace:
        raise HttpError(400, "name and namespace are required")
    nb = notebook_template(name, namespace)
    spec = nb["spec"]["template"]["spec"]
    container = spec["containers"][0]

    container["image"] = _image(body, defaults)
    _set_image_pull_policy(container, body, defaults)
    _set_cpu_ram(container, body, defaults)
    _set_gpu(nb, body, defaults)
    pvcs = _set_volumes(nb, body, defaults)
    _set_shm(nb, body, defaults)
    _set_configurations(nb, body, defaults)
    _set_tolerations(spec, body, defaults)
    _set_affinity(spec, body, defaults)
    _set_environment(container, defaults)
    return nb, pvcs


def _image(body, defaults) -> str:
    server_type = body.get("serverType", "jupyter")
    field = {
        "jupyter": "image",
        "group-two": "imageGroupTwo",
        "group-three": "imageGroupThree",
    }.get(server_type, "image")
    custom = body.get("customImage")
    if custom and body.get("customImageCheck"):
        # allowCustomImage is the admin gate (reference
        # spawner_ui_config:14); the group's readOnly additionally
        # pins the whole picker.
        if not defaults.get("allowCustomImage", True):
            raise HttpError(400, "custom images are disabled by the admin")
        if not defaults.get(field, {}).get("readOnly"):
            return str(custom).strip()
    return get_form_value(body, defaults, field)


def _set_image_pull_policy(container, body, defaults) -> None:
    if "imagePullPolicy" not in defaults:
        # Knob absent from the admin config: the control is disabled, so a
        # body-supplied value is ignored too (the SPA hiding a control is
        # not a gate) and kubelet's default applies.
        return
    policy = get_form_value(body, defaults, "imagePullPolicy")
    if not policy:
        return
    if policy not in ("Always", "IfNotPresent", "Never"):
        raise HttpError(400, f"invalid imagePullPolicy {policy!r}")
    container["imagePullPolicy"] = str(policy)


def _set_cpu_ram(container, body, defaults) -> None:
    cpu = str(get_form_value(body, defaults, "cpu"))
    mem = str(get_form_value(body, defaults, "memory"))
    # Validate before anything consumes them: a typo'd quantity must be a
    # form 400, not a 500 out of limit scaling or the quota pre-flight.
    from kubeflow_tpu_torch.platform.k8s import quota as quota_mod

    for field, value in (("cpu", cpu), ("memory", mem)):
        try:
            quota_mod.parse_quantity(value)
        except (ValueError, TypeError):
            raise HttpError(
                400, f"invalid {field} quantity {value!r}") from None
    requests = container["resources"]["requests"]
    limits = container["resources"]["limits"]
    requests["cpu"], requests["memory"] = cpu, mem
    cpu_factor = defaults.get("cpu", {}).get("limitFactor", "none")
    mem_factor = defaults.get("memory", {}).get("limitFactor", "none")
    if str(cpu_factor) != "none":
        limits["cpu"] = _scale_quantity(cpu, float(cpu_factor))
    if str(mem_factor) != "none":
        limits["memory"] = _scale_quantity(mem, float(mem_factor))


def _scale_quantity(q: str, factor: float) -> str:
    """Scale a k8s quantity ('4', '500m', '8Gi') by a factor."""
    units = ("Ki", "Mi", "Gi", "Ti", "Pi", "k", "M", "G", "T", "m")
    for unit in units:
        if q.endswith(unit):
            return f"{float(q[: -len(unit)]) * factor:g}{unit}"
    return f"{float(q) * factor:g}"


def _count(value, what: str):
    """A count from the form: an int, or a string of digits."""
    if isinstance(value, str) and value.strip().isdigit():
        value = int(value)
    if isinstance(value, bool) or not isinstance(value, int):
        raise HttpError(400, f"invalid GPU {what} {value!r}")
    return value


def _set_gpu(nb, body, defaults) -> None:
    gpu = get_form_value(body, defaults, "gpus", body_field="gpus") or {}
    accelerator = gpu.get("accelerator", "none")
    if not accelerator or accelerator == "none":
        return
    if accelerator not in ACCELERATORS:
        raise HttpError(400, f"unknown GPU accelerator {accelerator!r}")
    allowed = {
        opt["accelerator"]: opt.get("gpus", [])
        for opt in defaults.get("gpus", {}).get("options", [])
    }
    count = gpu.get("gpus")
    count = None if count in (None, "") else _count(count, "count")
    if allowed and accelerator not in allowed:
        raise HttpError(400, f"accelerator {accelerator!r} is not offered")
    if count is not None and allowed.get(accelerator) \
            and count not in allowed[accelerator]:
        raise HttpError(
            400, f"GPU count {count} not offered for {accelerator}"
        )
    slices = gpu.get("slices")
    if slices is not None:
        try:
            slices = int(slices)
        except (TypeError, ValueError):
            raise HttpError(400, f"invalid GPU slice count {slices!r}") from None
        if slices < 1:
            raise HttpError(400, f"invalid GPU slice count {slices}")
        # maxSlices: 0 (or absent) = single-slice only; multislice is an
        # explicit admin opt-in.
        max_slices = int(defaults.get("gpus", {}).get("maxSlices", 0) or 0)
        ceiling = max_slices if max_slices > 0 else 1
        if slices > ceiling:
            raise HttpError(
                400, f"slice count {slices} exceeds offered maximum {ceiling}"
            )
    try:
        slice_spec(accelerator, count, slices)
    except ValueError as e:
        raise HttpError(400, str(e)) from None
    nb["spec"]["gpu"] = {"accelerator": accelerator,
                         **({"gpus": count} if count else {}),
                         **({"slices": slices} if slices and slices > 1 else {})}


def _set_volumes(nb, body, defaults) -> List[dict]:
    spec = nb["spec"]["template"]["spec"]
    container = spec["containers"][0]
    name = nb["metadata"]["name"]
    pvcs: List[dict] = []

    def add(volume_def: dict):
        mount = volume_def.get("mount")
        new_pvc = volume_def.get("newPvc")
        existing = volume_def.get("existingSource")
        if new_pvc:
            pvc = copy.deepcopy(new_pvc)
            pvc.setdefault("apiVersion", "v1")
            pvc.setdefault("kind", "PersistentVolumeClaim")
            pvc_name = (
                pvc.get("metadata", {}).get("name", "")
                .replace("{notebook-name}", name)
            )
            pvc.setdefault("metadata", {})["name"] = pvc_name
            pvc["metadata"]["namespace"] = nb["metadata"]["namespace"]
            pvcs.append(pvc)
            vol_name = pvc_name
            source = {"persistentVolumeClaim": {"claimName": pvc_name}}
        elif existing:
            claim = existing.get("persistentVolumeClaim", {}).get("claimName", "vol")
            vol_name = claim
            source = existing
        else:
            return
        spec["volumes"].append({"name": vol_name, **source})
        if mount:
            container["volumeMounts"].append({"name": vol_name, "mountPath": mount})

    workspace = get_form_value(body, defaults, "workspaceVolume")
    if workspace:
        add(copy.deepcopy(workspace))
    for vol in get_form_value(body, defaults, "dataVolumes") or []:
        add(copy.deepcopy(vol))
    return pvcs


def _set_shm(nb, body, defaults) -> None:
    if not get_form_value(body, defaults, "shm"):
        return
    spec = nb["spec"]["template"]["spec"]
    spec["volumes"].append({"name": "dshm", "emptyDir": {"medium": "Memory"}})
    spec["containers"][0]["volumeMounts"].append(
        {"name": "dshm", "mountPath": "/dev/shm"}
    )


def _set_configurations(nb, body, defaults) -> None:
    # PodDefault opt-ins become pod labels the webhook selector matches.
    for label in get_form_value(body, defaults, "configurations") or []:
        nb["metadata"]["labels"][label] = "true"


def _set_tolerations(spec, body, defaults) -> None:
    group_key = get_form_value(body, defaults, "tolerationGroup")
    if not group_key:
        return
    for group in defaults.get("tolerationGroup", {}).get("options", []):
        if group.get("groupKey") == group_key:
            spec["tolerations"] = copy.deepcopy(group.get("tolerations", []))
            return
    raise HttpError(400, f"unknown toleration group {group_key!r}")


def _set_affinity(spec, body, defaults) -> None:
    key = get_form_value(body, defaults, "affinityConfig")
    if not key:
        return
    for option in defaults.get("affinityConfig", {}).get("options", []):
        if option.get("configKey") == key:
            spec["affinity"] = copy.deepcopy(option.get("affinity", {}))
            return
    raise HttpError(400, f"unknown affinity config {key!r}")


def _set_environment(container, defaults) -> None:
    env = defaults.get("environment", {}).get("value") or {}
    for k, v in env.items():
        container["env"].append({"name": k, "value": str(v)})
