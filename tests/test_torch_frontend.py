"""The port's SPAs (``kubeflow_tpu_torch/platform/frontend/``) executed
under the reference's JS interpreter and DOM shim (``kubeflow_tpu/
platform/testing/jsdom.py`` ``BrowserHarness``) against the port's WSGI
backends, each case beside the reference's SPA on the reference's
backend: the jupyter cases of ``tests/ctrlplane/test_frontend_dom.py``
that touch the picker, the form and the table (with the detail page),
and the volumes and tensorboards forms.  What reached each ``FakeKube``
and what rendered back into each DOM are compared under the TPU→GPU
mapping of ``test_torch_web_apps.py`` (``ref_words``), with the picker's
own words paired here: the ``#tpu-acc``/``#tpu-topo``/``#tpu-slices``
controls are ``#gpu-acc``/``#gpu-count``/``#gpu-slices``, a topology
``T`` is the count of its chips, "N of H TPU chips remaining" is "N of H
GPUs remaining", the detail's ``yaml`` tab is its ``manifest`` tab.

Last, every JS file of the port parses under the reference's engine, as
``test_jscorpus.py`` holds the reference's."""
import glob
import json
import os
import re
from types import SimpleNamespace

import pytest
from werkzeug.test import Client

from kubeflow_tpu.platform.testing.jsdom import BrowserHarness
from test_torch_web_apps import IMAGES, PORT, REF, TOPOLOGY, ref_words, strip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTEND = {
    REF.root: os.path.join(REPO, "kubeflow_tpu", "platform", "frontend"),
    PORT.root: os.path.join(REPO, "kubeflow_tpu_torch", "platform",
                            "frontend"),
}
CHIPS = {t: n for n, t in TOPOLOGY.items()}
# Rendered text: an image under each of the SPA's display forms (whole,
# short, without registry and tag), and the table's device cell.
SHOWN = sorted(
    [(a, b) for a, b in IMAGES.items()]
    + [(a.split("/")[-1], b.split("/")[-1]) for a, b in IMAGES.items()]
    + [(a.split("/", 1)[1].split(":")[0], b.split("/", 1)[1].split(":")[0])
       for a, b in IMAGES.items()], key=lambda ab: -len(ab[0]))
# Cells run together in a row's text: the longest count is tried first.
DEVICE_CELL = re.compile(r"h100-80gb × (64|32|16|8|4|1)")
# An age cell ("0s", before the row's next capitalized cell) or line
# ("3s ago").
AGE = re.compile(r"\d+[smhd](?: ago)?(?=[A-Z]|$)")


def shown(P, text):
    """Text ``P``'s SPA rendered, in the reference's words; a relative
    age is dropped from both."""
    text = AGE.sub("", text)
    if not P.gpu:
        return text
    for port, ref in SHOWN:
        text = text.replace(port, ref)
    return DEVICE_CELL.sub(lambda m: "v5e " + TOPOLOGY[int(m.group(1))],
                           text).replace("GPU", "TPU")


def words(P):
    """The picker's and the detail page's names in ``P``'s SPA."""
    if P.gpu:
        return SimpleNamespace(acc="#gpu-acc", pick="#gpu-count",
                               slices="#gpu-slices",
                               label="#gpu-quota-label",
                               accelerator="h100-80gb",
                               value=lambda t: str(CHIPS[t]),
                               tab="manifest")
    return SimpleNamespace(acc="#tpu-acc", pick="#tpu-topo",
                           slices="#tpu-slices", label="#tpu-quota-label",
                           accelerator="v5e", value=lambda t: t,
                           tab="yaml")


def kube_of(P, nodes=("node-1",)):
    k = P.FakeKube()
    k.add_namespace("user1")
    for name in nodes:
        if P.gpu:
            k.add_gpu_node(name, gpus=8)
        else:
            k.add_tpu_node(name, topology="2x4")
    return k


def harness(P, app, kube, *, url="http://spa.test/?ns=user1",
            secure_cookies=False, config_path=None):
    create = getattr(P, app).create_app
    kw = {"spawner_config_path": config_path} if config_path else {}
    client = Client(create(kube, secure_cookies=secure_cookies, **kw))
    return BrowserHarness(os.path.join(FRONTEND[P.root], app), client,
                          url=url)


def both(script):
    """``script(P)`` on each package: (reference, port in the reference's
    words)."""
    ref = strip(json.loads(json.dumps(script(REF), default=str)))
    got = ref_words(json.loads(json.dumps(script(PORT), default=str)))
    return ref, got


def notebook(P, kube, name):
    nb = json.loads(json.dumps(kube.get(P.types.NOTEBOOK, name, "user1"),
                               default=P.types.json_default))
    nb["metadata"].pop("resourceVersion", None)
    return nb


def names(P, kube, kind):
    return sorted(o["metadata"]["name"]
                  for o in kube.list(getattr(P.types, kind), "user1"))


# -- the spawner ----------------------------------------------------------------


def test_spawn_flow_end_to_end():
    def script(P):
        w = words(P)
        kube = kube_of(P)
        h = harness(P, "jupyter", kube)
        h.click("#new-notebook")
        out = [h.get("spawner").open,
               [o.textContent for o in h.query_all(w.acc + " option")]]
        h.set_value("[name=name]", "my-nb", event="input")
        h.set_value("[name=cpu]", "3", event="input")
        h.set_value("[name=memory]", "9Gi", event="input")
        h.set_value(w.acc, w.accelerator)
        h.set_value(w.pick, w.value("2x4"))
        h.submit("#spawn-form")
        out += [notebook(P, kube, "my-nb"), names(P, kube, "PVC"),
                h.text("#toast"), h.get("spawner").open, h.errors]
        h.fire_timers()
        out.append([shown(P, r.textContent)
                    for r in h.query_all("#nb-table tbody tr")])
        return out

    ref, got = both(script)
    assert got == ref
    assert got[2]["spec"]["tpu"] == {"accelerator": "v5e", "topology": "2x4"}
    assert got[4] == "Launching my-nb" and got[5] is False and got[6] == []


def test_gpu_picker_lists_counts_a_node_holds():
    kube = kube_of(PORT, nodes=())
    kube.add_gpu_node("small", gpus=4)
    h = harness(PORT, "jupyter", kube)
    h.click("#new-notebook")
    h.set_value("#gpu-acc", "h100-80gb")
    assert [o.textContent for o in h.query_all("#gpu-count option")] == [
        "1", "2", "4"]
    assert h.get("gpu-quota-label").hidden
    h.set_value("[name=name]", "two", event="input")
    h.set_value("#gpu-count", "2")
    h.submit("#spawn-form")
    nb = kube.get(PORT.types.NOTEBOOK, "two", "user1")
    assert nb["spec"]["gpu"] == {"accelerator": "h100-80gb", "gpus": 2}
    post = [r for r in h.requests if r["method"] == "POST"][-1]
    assert json.loads(post["body"])["gpus"] == {"accelerator": "h100-80gb",
                                                "gpus": 2}


@pytest.mark.parametrize("case", [
    "workspace-none", "custom-image", "error", "server-type",
    "custom-workspace", "data-volume-new", "data-volume-existing",
    "remove-row", "shm", "affinity", "pull-policy", "pull-policy-reopen",
    "poddefault", "csrf"])
def test_spawner_form_equals_the_reference(case):
    def script(P):
        kube = kube_of(P)
        if case == "data-volume-existing":
            kube.create({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                         "metadata": {"name": "datasets",
                                      "namespace": "user1"},
                         "spec": {"resources": {"requests": {
                             "storage": "100Gi"}},
                             "accessModes": ["ReadWriteMany"]}})
        if case == "poddefault":
            if P.gpu:
                from kubeflow_tpu_torch.platform.apis.poddefault import (
                    gpu_pod_default,
                )
                kube.create(gpu_pod_default("user1", "h100-80gb", 8))
            else:
                from kubeflow_tpu.platform.apis.poddefault import (
                    tpu_pod_default,
                )
                kube.create(tpu_pod_default("user1", "v5e", "2x4"))
        h = harness(P, "jupyter", kube, secure_cookies=case == "csrf")
        h.click("#new-notebook")
        out = []
        name = case
        h.set_value("[name=name]", name, event="input")
        if case == "workspace-none":
            h.set_value("#workspace-select", "none")
        elif case == "custom-image":
            out.append(h.get("custom-image-row").hidden)
            h.set_value("#image-select", "__custom__")
            out.append(h.get("custom-image-row").hidden)
            h.set_value("[name=customImage]", "registry.io/me/img:1",
                        event="input")
        elif case == "error":
            h.set_value("[name=name]", "", event="input")
        elif case == "server-type":
            out.append([o.value for o in h.get("image-select").options])
            h.query("[name=serverType][value=group-two]").click()
            out.append([o.value for o in h.get("image-select").options])
        elif case == "custom-workspace":
            h.set_value("#workspace-select", "custom")
            out.append(h.get("workspace-custom-row").hidden)
            h.set_value("[name=workspaceName]", "scratch", event="input")
            h.set_value("[name=workspaceSize]", "42Gi", event="input")
        elif case == "data-volume-new":
            h.click("#add-volume")
            h.set_value("#data-volumes .vol-row .vol-name", "dv-data",
                        event="input")
            h.set_value("#data-volumes .vol-row .vol-size", "5Gi",
                        event="input")
            h.set_value("#data-volumes .vol-row .vol-mount", "/data/x",
                        event="input")
        elif case == "data-volume-existing":
            h.click("#add-volume")
            h.set_value("#data-volumes .vol-row .vol-type", "existing")
            out.append([o.value for o in h.query(
                "#data-volumes .vol-row .vol-existing").options])
            h.set_value("#data-volumes .vol-row .vol-existing", "datasets")
            h.set_value("#data-volumes .vol-row .vol-mount", "/data/sets",
                        event="input")
        elif case == "remove-row":
            h.click("#add-volume")
            h.click("#add-volume")
            out.append(len(h.query_all("#data-volumes .vol-row")))
            h.query("#data-volumes .vol-row .vol-remove").click()
            out.append(len(h.query_all("#data-volumes .vol-row")))
        elif case == "shm":
            out.append(h.get("shm-check").checked)
            h.get("shm-check").click()
        elif case == "affinity":
            pool = "gpu" if P.gpu else "tpu"
            h.set_value("#affinity-select", f"{pool}-node-pool")
            h.set_value("#toleration-select", f"{pool}-reserved")
        elif case == "pull-policy":
            out.append((h.get("image-pull-policy-row").hidden,
                        h.query("#image-pull-policy").value))
            h.set_value("#image-pull-policy", "IfNotPresent")
        elif case == "pull-policy-reopen":
            h.submit("#spawn-form")
            h.click("#new-notebook")
            out.append(h.query("#image-pull-policy").value)
            name = "second"
            h.set_value("[name=name]", name, event="input")
        elif case == "poddefault":
            chips = h.query_all("#poddefault-chips .chip")
            out.append(len(chips))
            chips[0].click()
        h.submit("#spawn-form")
        out.append(notebook(P, kube, name)
                   if name in names(P, kube, "NOTEBOOK") else None)
        out += [names(P, kube, "PVC"), h.text("#toast"),
                h.query("#toast").classList.contains("error"), h.errors]
        if case == "csrf":
            post = next(r for r in h.requests if r["method"] == "POST")
            out.append(post["path"])
        return out

    ref, got = both(script)
    assert got == ref
    if case == "error":
        assert got[0] is None and got[-2] is True
    elif case == "csrf":
        assert got[0]["metadata"]["name"] == "csrf"


def test_read_only_and_admin_knobs_equal_the_reference(tmp_path):
    """The reference's config-knob cases: a readOnly cpu disables its
    control and the admin value wins; imagePullPolicy absent hides its
    row and a hand-made body value is dropped, readOnly pins it;
    allowCustomImage false hides the option and the backend refuses a
    hand-made body; hideRegistry/hideTag rewrite the shown names only."""
    import yaml

    def script(P):
        out = []
        base = P.form.load_spawner_config()

        def with_config(overrides, drop=()):
            cfg = {**base, **overrides}
            for key in drop:
                cfg.pop(key, None)
            path = tmp_path / f"{P.root}-{len(out)}.cfg"
            doc = {"spawnerFormDefaults": cfg}
            path.write_text(json.dumps(doc) if P.gpu else
                            yaml.safe_dump(doc))
            kube = kube_of(P)
            return kube, harness(P, "jupyter", kube,
                                 config_path=str(path))

        def post(h, body):
            client = h.clients[""]
            r = client.post("/api/namespaces/user1/notebooks", json=body,
                            headers={"kubeflow-userid":
                                     "test-user@kubeflow.org"})
            return r.status_code, r.get_json()

        kube, h = with_config({"cpu": {"value": "2", "readOnly": True}})
        h.click("#new-notebook")
        out.append(h.query("[name=cpu]").disabled)
        h.set_value("[name=name]", "ro", event="input")
        h.submit("#spawn-form")
        out.append(notebook(P, kube, "ro"))
        kube, h = with_config({}, drop=("imagePullPolicy",))
        h.click("#new-notebook")
        out.append(h.get("image-pull-policy-row").hidden)
        out.append(post(h, {"name": "no-knob", "imagePullPolicy": "Never"}))
        out.append(notebook(P, kube, "no-knob"))
        kube, h = with_config({"imagePullPolicy": {"value": "Never",
                                                   "readOnly": True}})
        h.click("#new-notebook")
        out.append(h.query("#image-pull-policy").disabled)
        h.set_value("[name=name]", "pp-ro", event="input")
        h.submit("#spawn-form")
        out.append(notebook(P, kube, "pp-ro"))
        kube, h = with_config({"allowCustomImage": False})
        h.click("#new-notebook")
        out.append([o.value for o in h.query_all("#image-select option")])
        out.append(post(h, {"name": "sneak", "customImage": "evil/img:1",
                            "customImageCheck": True}))
        for hide in (True, False):
            kube, h = with_config({"hideRegistry": hide, "hideTag": hide})
            h.click("#new-notebook")
            out.append([shown(P, o.textContent)
                        for o in h.query_all("#image-select option")])
            h.set_value("[name=name]", f"disp-{hide}".lower(), event="input")
            h.submit("#spawn-form")
            out.append(notebook(P, kube, f"disp-{hide}".lower()))
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0] is True and got[1]["spec"]["template"]["spec"][
        "containers"][0]["resources"]["requests"]["cpu"] == "2"
    assert got[8][0] == 400


# -- the GPU picker and the quota ------------------------------------------------


def _quota(P, n):
    key = "nvidia.com/gpu" if P.gpu else "google.com/tpu"
    return {"apiVersion": "v1", "kind": "ResourceQuota",
            "metadata": {"name": "kf-resource-quota", "namespace": "user1"},
            "spec": {"hard": {key: str(n)}}}


def _options(h, w):
    return [(o.attributes.get("value"), o.disabled, o.textContent)
            for o in h.query_all(w.pick + " option")]


def test_picker_disables_over_quota_counts():
    """The reference's over-budget case: a 4x4 (16 chips) over an 8-chip
    budget is disabled with "(over quota)" and 2x4 (8) stays; the port
    offers counts, so its 16 is disabled and its 8 stays."""

    def script(P):
        w = words(P)
        kube = kube_of(P, nodes=("node-1", "node-2"))
        if not P.gpu:
            kube.delete(P.types.NODE, "node-2")
            kube.add_tpu_node("node-2", topology="4x4")
        kube.create(_quota(P, 8))
        h = harness(P, "jupyter", kube)
        h.click("#new-notebook")
        out = [h.get(w.label[1:]).hidden, h.text(w.label)]
        h.set_value(w.acc, w.accelerator)
        opts = {v: (d, t) for v, d, t in _options(h, w)}
        out.append([opts[w.value(t)] for t in ("2x4", "4x4")])
        out.append(h.get(w.pick[1:]).value)
        return out

    ref, got = both(script)
    assert ref[1] == "8 of 8 TPU chips remaining"
    assert got[1] == "8 of 8 GPUs remaining"
    assert got[0] == ref[0] is False
    assert ref[2] == [[False, "2x4"], [True, "4x4 (over quota)"]]
    assert got[2] == [[False, "8"], [True, "16 (over quota)"]]
    # The port's whole list: what fits is enabled, the rest is not.
    kube = kube_of(PORT)
    kube.create(_quota(PORT, 4))
    h = harness(PORT, "jupyter", kube)
    h.click("#new-notebook")
    h.set_value("#gpu-acc", "h100-80gb")
    assert _options(h, words(PORT)) == [
        ("1", False, "1"), ("2", False, "2"), ("4", False, "4"),
        ("8", True, "8 (over quota)"), ("16", True, "16 (over quota)"),
        ("32", True, "32 (over quota)"), ("64", True, "64 (over quota)")]
    assert h.get("gpu-count").value == "1"


def test_picker_counts_used_devices():
    def script(P):
        w = words(P)
        kube = kube_of(P)
        kube.create(_quota(P, 8))
        key = "nvidia.com/gpu" if P.gpu else "google.com/tpu"
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "holder-0", "namespace": "user1"},
                     "spec": {"containers": [{"name": "c", "resources": {
                         "limits": {key: "8"}}}]}})
        h = harness(P, "jupyter", kube)
        h.click("#new-notebook")
        out = [h.text(w.label)]
        h.set_value(w.acc, w.accelerator)
        opts = _options(h, w)
        out.append(bool(opts) and all(d for _v, d, _t in opts))
        return out

    ref, got = both(script)
    assert ref == ["0 of 8 TPU chips remaining", True]
    assert got == ["0 of 8 GPUs remaining", True]


def test_slice_change_preserves_the_pick(tmp_path):
    """The reference offers the 2x4 and 4x4 its nodes carry; the port is
    given the same two sizes (8 and 16 GPUs) as its admin's offer, so
    that the first admissible pick is the same size on both."""

    def script(P):
        w = words(P)
        kube = kube_of(P, nodes=("node-1", "node-2"))
        config = None
        if P.gpu:
            cfg = P.form.load_spawner_config()
            cfg = {**cfg, "gpus": {**cfg["gpus"], "options": [
                {"accelerator": "h100-80gb", "gpus": [8, 16]}]}}
            config = tmp_path / "spawner.json"
            config.write_text(json.dumps({"spawnerFormDefaults": cfg}))
        else:
            kube.delete(P.types.NODE, "node-2")
            kube.add_tpu_node("node-2", topology="4x4")
        kube.create(_quota(P, 32))
        h = harness(P, "jupyter", kube,
                    config_path=str(config) if config else None)
        h.click("#new-notebook")
        h.set_value(w.acc, w.accelerator)
        h.set_value(w.pick, w.value("4x4"))
        out = [h.get(w.slices[1:] + "-label").hidden]
        h.set_value(w.slices, "2")      # 2 x 16 = 32: still fits
        out.append(h.get(w.pick[1:]).value)
        h.set_value(w.slices, "3")      # 3 x 16 = 48: over the budget
        out.append(h.get(w.pick[1:]).value)
        opts = {v: d for v, d, _t in _options(h, w)}
        out.append((opts[w.value("4x4")], opts[w.value("2x4")]))
        h.set_value("[name=name]", "ms", event="input")
        h.submit("#spawn-form")
        out.append(notebook(P, kube, "ms"))
        return out

    ref, got = both(script)
    assert got[0] == ref[0] is False
    assert ref[1:3] == ["4x4", "2x4"] and got[1:3] == ["16", "8"]
    assert got[3] == ref[3] == [True, False]
    assert got[4] == ref[4]
    assert got[4]["spec"]["tpu"] == {"accelerator": "v5e",
                                     "topology": "2x4", "slices": 3}


# -- the table and the detail page ------------------------------------------------


def _mk_nb(P, kube, name, memory=None, device=False):
    container = {"name": name, "image": "img"}
    if memory:
        container["resources"] = {"requests": {"memory": memory}}
    spec = {"template": {"spec": {"containers": [container]}}}
    if device:
        spec["gpu" if P.gpu else "tpu"] = (
            {"accelerator": "h100-80gb", "gpus": 8} if P.gpu
            else {"accelerator": "v5e", "topology": "2x4"})
    kube.create({"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
                 "metadata": {"name": name, "namespace": "user1"},
                 "spec": spec})


def test_table_actions_sort_filter_and_pages_equal_the_reference():
    def script(P):
        kube = kube_of(P)
        h = harness(P, "jupyter", kube)

        def rows():
            return [a.textContent
                    for a in h.query_all("#nb-table tbody a.nb-name")]

        out = []
        for i in range(12):
            _mk_nb(P, kube, f"nb-{i:02d}", memory=f"{(i % 3) + 1}Gi",
                   device=i == 0)
        h.fire_timers()
        out.append((rows(), h.text("#nb-pager .pager-label"),
                    h.query("#nb-pager .pager-prev").disabled))
        h.query("#nb-pager .pager-next").click()
        out.append((rows(), h.text("#nb-pager .pager-label")))
        h.query("#nb-pager .pager-prev").click()
        for key in ("name", "name", "memory", "status"):
            th = h.query(f'th[data-sort="{key}"]')
            th.click()
            out.append((key, rows(), th.className))
        h.set_value("#nb-filter", "nb-1", event="input")
        out.append(rows())
        h.set_value("#nb-filter", "", event="input")
        h.query("#nb-table tbody button.ghost").click()  # Stop
        out.append(sorted(kube.get(P.types.NOTEBOOK, rows()[0], "user1")[
            "metadata"].get("annotations", {})))
        h.confirm_response = False
        h.query("#nb-table tbody button.danger").click()
        out.append(len(names(P, kube, "NOTEBOOK")))
        h.confirm_response = True
        h.query("#nb-table tbody button.danger").click()
        out.append((h.confirm_prompts[-1], len(names(P, kube, "NOTEBOOK"))))
        out.append(h.errors)
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0][1] == "1–10 of 12" and got[-2][1] == 11


def test_device_column_sorts_and_shows_the_gpus():
    kube = kube_of(PORT)
    _mk_nb(PORT, kube, "cpu-nb")
    _mk_nb(PORT, kube, "gpu-nb", device=True)
    h = harness(PORT, "jupyter", kube)
    h.fire_timers()
    assert h.text('th[data-sort="gpu"]') == "GPU"
    th = h.query('th[data-sort="gpu"]')
    # An empty cell sorts before "h100-80gb 8", then the order flips.
    for order in (["cpu-nb", "gpu-nb"], ["gpu-nb", "cpu-nb"]):
        th.click()
        assert [a.textContent for a in h.query_all(
            "#nb-table tbody a.nb-name")] == order
    row = next(r for r in h.query_all("#nb-table tbody tr")
               if "gpu-nb" in r.textContent)
    assert "h100-80gb × 8" in row.textContent


def _detail(P, kube):
    kube.create({
        "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
        "metadata": {"name": "det-nb", "namespace": "user1"},
        "spec": {
            ("gpu" if P.gpu else "tpu"): (
                {"accelerator": "h100-80gb", "gpus": 8, "slices": 2}
                if P.gpu else {"accelerator": "v5e", "topology": "2x4",
                               "slices": 2}),
            "template": {"spec": {"containers": [{
                "name": "det-nb", "image": "ghcr.io/x/img:1",
                "resources": {"requests": {"cpu": "4", "memory": "8Gi"}},
            }], "volumes": [{"name": "ws", "emptyDir": {}}]}}},
        "status": {"conditions": [{"type": "Ready", "status": "True",
                                   "reason": "Running", "message": "ok"}]},
    })
    kube.create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "det-nb-0", "namespace": "user1",
                              "labels": {"notebook-name": "det-nb"}},
                 "spec": {"containers": [{"name": "det-nb",
                                          "image": "ghcr.io/x/img:1"}]}})
    kube.set_pod_logs("user1", "det-nb-0", "line-1\njupyter up on :8888",
                      container="det-nb")
    kube.create({"apiVersion": "v1", "kind": "Event",
                 "metadata": {"name": "det-ev", "namespace": "user1"},
                 "involvedObject": {"kind": "Pod", "name": "det-nb-0",
                                    "namespace": "user1"},
                 "reason": "Pulled", "message": "image pulled",
                 "type": "Normal", "lastTimestamp": "2099-01-01T00:00:00Z"})


def test_detail_page_equals_the_reference():
    import yaml

    def script(P):
        w = words(P)
        kube = kube_of(P)
        _detail(P, kube)
        h = harness(P, "jupyter", kube)
        h.fire_timers()
        h.query("#nb-table tbody a.nb-name").click()
        out = [h.get("view-table").hidden, h.get("view-detail").hidden,
               h.text("#detail-title"),
               h.query("#cond-table tbody").textContent,
               h.get("detail-connect").href]
        out.append(shown(P, h.text("#overview-list")))
        h.query("#detail-tabs [data-tab=logs]").click()
        out.append(([o.value for o in h.get("log-pod-select").options],
                    h.text("#log-output")))
        h.query("#detail-tabs [data-tab=events]").click()
        out.append(h.query("#ev-table tbody").textContent)
        h.query(f"#detail-tabs [data-tab={w.tab}]").click()
        text = h.text(f"#{w.tab}-output")
        parsed = yaml.safe_load(text)
        parsed["metadata"].pop("resourceVersion", None)
        out.append(parsed)
        h.click("#detail-back")
        out.append((h.get("view-table").hidden, h.get("view-detail").hidden))
        deep = harness(P, "jupyter", kube,
                       url="http://spa.test/?ns=user1&nb=det-nb")
        out.append((deep.get("view-detail").hidden,
                    deep.text("#detail-title")))
        out.append(h.errors + deep.errors)
        return out

    ref, got = both(script)
    assert got == ref
    assert "v5e 2x4" in got[5] and "× 2 slices" in got[5]
    assert got[8]["spec"]["tpu"] == {"accelerator": "v5e",
                                     "topology": "2x4", "slices": 2}


# -- volumes and tensorboards ------------------------------------------------------


def test_volumes_and_tensorboards_forms_equal_the_reference():
    def script(P):
        out = []
        kube = kube_of(P)
        h = harness(P, "volumes", kube)
        h.click("#new-pvc")
        h.set_value("[name=name]", "data-1", event="input")
        h.set_value("[name=size]", "20Gi", event="input")
        h.submit("#create-form")
        out.append(names(P, kube, "PVC"))
        h.fire_timers()
        out.append([shown(P, r.textContent)
                    for r in h.query_all("#pvc-table tbody tr")])
        h.query("#pvc-table tbody button.danger").click()
        out.append((h.confirm_prompts[-1], names(P, kube, "PVC")))
        kube.create({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                     "metadata": {"name": "busy", "namespace": "user1"},
                     "spec": {"resources": {"requests": {"storage": "1Gi"}},
                              "accessModes": ["ReadWriteOnce"]}})
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "user-pod", "namespace": "user1"},
                     "spec": {"volumes": [{"name": "v",
                                           "persistentVolumeClaim": {
                                               "claimName": "busy"}}],
                              "containers": [{"name": "c", "image": "i"}]}})
        h.fire_timers()
        out.append((h.query("#pvc-table tbody button.danger").hasAttribute(
            "disabled"), shown(P, h.query("#pvc-table tbody").textContent)))
        t = harness(P, "tensorboards", kube)
        t.click("#new-tb")
        t.set_value("[name=name]", "tb-1", event="input")
        t.set_value("[name=logspath]", "pvc://busy/logs", event="input")
        t.submit("#create-form")
        tb = kube.get(P.types.TENSORBOARD, "tb-1", "user1")
        out.append(tb["spec"])
        t.fire_timers()
        out.append(shown(P, t.query("#tb-table tbody").textContent))
        out.append(h.errors + t.errors)
        return out

    ref, got = both(script)
    assert got == ref
    assert got[0] == ["data-1"] and got[2][1] == []
    assert got[3][0] is True and "user-pod" in got[3][1]


# -- the engine parses every port JS file --------------------------------------------

PORT_JS = sorted(glob.glob(os.path.join(FRONTEND[PORT.root], "*", "*.js")))


def test_the_port_ships_the_four_spas():
    apps = {os.path.basename(os.path.dirname(p)) for p in PORT_JS}
    assert apps == {"shared", "jupyter", "volumes", "tensorboards"}
    for app in ("jupyter", "volumes", "tensorboards"):
        assert os.path.isfile(os.path.join(FRONTEND[PORT.root], app,
                                           "index.html"))


@pytest.mark.parametrize("path", PORT_JS,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_every_port_js_file_parses_under_the_reference_engine(path):
    from kubeflow_tpu.platform.testing.jsengine import Parser, tokenize

    with open(path) as f:
        src = f.read()
    program = Parser(tokenize(src, path), path).parse_program()
    assert program


def test_the_corpus_covers_the_port_bundles(monkeypatch):
    """The reference's coverage contract over the port's bundles: every
    construct they use is exercised by a fixture of the reference's
    differential corpus, so the engine that runs the tests above is
    certified for the port's SPAs too."""
    from kubeflow_tpu.platform.testing import jsinventory

    monkeypatch.setattr(jsinventory, "BUNDLE_PATHS", PORT_JS)
    gaps = jsinventory.coverage_gaps(os.path.join(
        REPO, "tests", "ctrlplane", "jscorpus"))
    assert all(not v for v in gaps.values()), {
        k: sorted(v) for k, v in gaps.items() if v}
