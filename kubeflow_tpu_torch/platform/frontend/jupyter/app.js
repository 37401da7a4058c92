/* Notebook spawner + table + detail SPA.  The GPU accelerator and
   GPU-count selector replaces the reference's GPU vendor dropdown
   (form-gpus component); a count the namespace's GPU quota cannot admit
   is disabled.  The spawner exposes every backend form setter (form.py):
   server type image groups, cpu/memory, GPUs + multislice, workspace volume
   (default/custom/none), data volumes (new PVC or attach existing),
   shm, PodDefault configurations, affinity/toleration groups.  The detail
   view is the reference's notebook-page (overview/logs/events/manifest tabs,
   reference jupyter/frontend/src/app/pages/notebook-page/). */
import {
  api, namespace, el, toast, statusDot, age, poll, confirmDialog, tableView,
  parseQuantity,
} from "./shared/common.js";

const ns = namespace();
document.getElementById("ns-label").textContent = "namespace: " + ns;

let config = null;
let offeredGpus = [];
let gpuQuota = null; /* {hard, used, remaining} GPUs, or null: no quota */
let existingPvcs = [];
let volumeRows = [];
let detailName = null;

const IMAGE_GROUPS = {
  "jupyter": "image",
  "group-two": "imageGroupTwo",
  "group-three": "imageGroupThree",
};

function serverType() {
  const checked = document.querySelector("[name=serverType]:checked");
  return checked ? checked.value : "jupyter";
}

function displayImageName(image) {
  // hideRegistry/hideTag rewrite only what the user SEES; option values
  // (and the submitted body) always carry the full reference.
  let name = String(image);
  if (config.hideRegistry) {
    // Docker's registry heuristic: the first segment is a registry host
    // only if it contains "." or ":" or is exactly "localhost".
    const parts = name.split("/");
    if (parts.length > 1 && (parts[0].includes(".") || parts[0].includes(":")
        || parts[0] === "localhost")) {
      parts.shift();
    }
    name = parts.join("/");
  }
  if (config.hideTag && !name.includes("@")) {
    // Digest references (repo@sha256:...) keep their digest verbatim.
    const slash = name.lastIndexOf("/");
    const colon = name.lastIndexOf(":");
    if (colon > slash) name = name.slice(0, colon);
  }
  return name;
}

function fillImageSelect() {
  const field = IMAGE_GROUPS[serverType()] || "image";
  const group = config[field] || {};
  const select = document.getElementById("image-select");
  select.replaceChildren();
  for (const image of group.options || [group.value]) {
    const opt = el("option", { value: image }, displayImageName(image));
    if (image === group.value) opt.setAttribute("selected", "");
    select.append(opt);
  }
  if (!group.readOnly && config.allowCustomImage !== false) {
    select.append(el("option", { value: "__custom__" }, "custom image…"));
  }
  select.disabled = !!group.readOnly;
  document.getElementById("custom-image-row").hidden = true;
}

function applyReadOnly(field, control) {
  if ((config[field] || {}).readOnly) control.disabled = true;
}

async function loadConfig() {
  config = (await api("/api/config")).config;
  fillImageSelect();
  const select = document.getElementById("image-select");
  select.addEventListener("change", () => {
    document.getElementById("custom-image-row").hidden = select.value !== "__custom__";
  });
  for (const radio of document.querySelectorAll("[name=serverType]")) {
    radio.addEventListener("change", fillImageSelect);
  }
  const cpu = document.querySelector("[name=cpu]");
  const memory = document.querySelector("[name=memory]");
  cpu.value = config.cpu.value;
  memory.value = config.memory.value;
  applyReadOnly("cpu", cpu);
  applyReadOnly("memory", memory);
  const shm = document.getElementById("shm-check");
  shm.checked = !!(config.shm && config.shm.value);
  applyReadOnly("shm", shm);
  const pullPolicy = document.getElementById("image-pull-policy");
  const pullCfg = config.imagePullPolicy || {};
  if (pullCfg.value) {
    document.getElementById("image-pull-policy-row").hidden = false;
    pullPolicy.value = pullCfg.value;
    applyReadOnly("imagePullPolicy", pullPolicy);
  }
  const affinity = document.getElementById("affinity-select");
  for (const opt of (config.affinityConfig && config.affinityConfig.options) || []) {
    affinity.append(el("option", { value: opt.configKey }, opt.displayName || opt.configKey));
  }
  applyReadOnly("affinityConfig", affinity);
  const tolerations = document.getElementById("toleration-select");
  for (const opt of (config.tolerationGroup && config.tolerationGroup.options) || []) {
    tolerations.append(el("option", { value: opt.groupKey }, opt.displayName || opt.groupKey));
  }
  applyReadOnly("tolerationGroup", tolerations);
  applyReadOnly("workspaceVolume", document.getElementById("workspace-select"));
}

function syncGpuCounts() {
  const acc = document.getElementById("gpu-acc");
  const count = document.getElementById("gpu-count");
  const sel = offeredGpus.find((o) => o.accelerator === acc.value);
  count.disabled = !sel;
  const previous = count.value; /* survive the rebuild (slice-count changes) */
  count.replaceChildren();
  const slices = parseInt(document.getElementById("gpu-slices").value, 10) || 1;
  for (const n of (sel ? sel.gpus : [])) {
    const opt = el("option", { value: String(n) }, String(n));
    /* Disable picks the namespace quota can't admit: the backend would
       403 them at the pre-flight anyway (quota-aware spawner UX). */
    if (gpuQuota && n * slices > gpuQuota.remaining) {
      opt.disabled = true;
      opt.textContent = `${n} (over quota)`;
    }
    count.append(opt);
  }
  /* Rebuilding dropped the selection: keep the user's pick if it's still
     offered and admissible, else the first enabled option (a disabled
     default would submit anyway). */
  const options = [...count.options];
  const keep = options.find((o) => o.getAttribute("value") === previous && !o.disabled);
  const firstOk = options.find((o) => !o.disabled);
  if (keep) {
    count.value = keep.getAttribute("value");
  } else if (firstOk) {
    count.value = firstOk.getAttribute("value");
  }
  const label = document.getElementById("gpu-quota-label");
  label.hidden = !gpuQuota;
  if (gpuQuota) {
    label.textContent =
      `${gpuQuota.remaining} of ${gpuQuota.hard} GPUs remaining`;
  }
}

async function loadGpus() {
  const acc = document.getElementById("gpu-acc");
  try {
    const resp = await api(`/api/namespaces/${ns}/gpus`);
    offeredGpus = resp.gpus;
    gpuQuota = resp.quota || null;
  } catch (e) {
    /* no nodes visible: fall back to the admin-offered list */
    offeredGpus = (config && config.gpus && config.gpus.options) || [];
    gpuQuota = null;
  }
  acc.replaceChildren(el("option", { value: "" }, "none"));
  for (const option of offeredGpus) {
    acc.append(el("option", { value: option.accelerator }, option.accelerator));
  }
  // Multislice is an admin opt-in (gpus.maxSlices > 1 in the spawner config).
  const maxSlices = (config && config.gpus && config.gpus.maxSlices) || 0;
  const slicesLabel = document.getElementById("gpu-slices-label");
  slicesLabel.hidden = maxSlices <= 1;
  if (maxSlices > 1) document.getElementById("gpu-slices").max = maxSlices;
  syncGpuCounts();
}

async function loadPoddefaults() {
  const chips = document.getElementById("poddefault-chips");
  chips.replaceChildren();
  let pds = [];
  try {
    pds = (await api(`/api/namespaces/${ns}/poddefaults`)).poddefaults;
  } catch (e) { /* none */ }
  if (!pds.length) {
    chips.append(el("span", { class: "muted" }, "none available"));
    return;
  }
  for (const pd of pds) {
    const chip = el("span", { class: "chip", "data-label": pd.label, title: pd.desc }, pd.desc);
    chip.addEventListener("click", () => chip.classList.toggle("on"));
    chips.append(chip);
  }
}

async function loadExistingPvcs() {
  try {
    // The route returns raw PVC objects (name under metadata).
    existingPvcs = (await api(`/api/namespaces/${ns}/pvcs`)).pvcs
      .map((p) => (p.metadata ? p.metadata.name : p.name));
  } catch (e) {
    existingPvcs = [];
  }
  for (const row of volumeRows) fillPvcOptions(row);
}

/* -- data volume rows (reference form-data-volumes component) ------------- */

function fillPvcOptions(row) {
  if (!row.pvcSel) return;
  const current = row.pvcSel.value;
  row.pvcSel.replaceChildren();
  for (const name of existingPvcs) {
    row.pvcSel.append(el("option", { value: name }, name));
  }
  if (current) row.pvcSel.value = current;
}

let volumeRowSeq = 0;

function addVolumeRow() {
  volumeRowSeq += 1; // monotonic: a removed row's mount path never recurs
  const typeSel = el("select", { class: "vol-type" },
    el("option", { value: "new" }, "New PVC"),
    el("option", { value: "existing" }, "Existing PVC"));
  const nameIn = el("input", { class: "vol-name", placeholder: "{notebook-name}-data" });
  const sizeIn = el("input", { class: "vol-size", value: "10Gi" });
  const pvcSel = el("select", { class: "vol-existing" });
  const mountIn = el("input", { class: "vol-mount", value: `/data/vol-${volumeRowSeq}` });
  const removeBtn = el("button", { type: "button", class: "ghost vol-remove" }, "✕");
  const newFields = el("span", {}, nameIn, sizeIn);
  const existingFields = el("span", { hidden: "" }, pvcSel);
  const root = el("div", { class: "row vol-row" },
    typeSel, newFields, existingFields, el("span", {}, "mount at"), mountIn, removeBtn);
  const row = { root, typeSel, nameIn, sizeIn, pvcSel, mountIn };
  typeSel.addEventListener("change", () => {
    newFields.hidden = typeSel.value !== "new";
    existingFields.hidden = typeSel.value !== "existing";
  });
  removeBtn.addEventListener("click", () => {
    volumeRows = volumeRows.filter((r) => r !== row);
    root.remove();
  });
  fillPvcOptions(row);
  volumeRows.push(row);
  document.getElementById("data-volumes").append(root);
  return row;
}

function clearVolumeRows() {
  volumeRows = [];
  document.getElementById("data-volumes").replaceChildren();
}

/* -- spawn ---------------------------------------------------------------- */

function connectUrl(nb) {
  return `/notebook/${nb.namespace || ns}/${nb.name}/`;
}

function spawnBody(form) {
  const data = new FormData(form);
  const body = {
    name: data.get("name"),
    serverType: data.get("serverType") || "jupyter",
    cpu: data.get("cpu"),
    memory: data.get("memory"),
    shm: !!data.get("shm"),
    configurations: [...document.querySelectorAll("#poddefault-chips .chip.on")]
      .map((chip) => chip.dataset.label),
  };
  if (data.get("image") === "__custom__") {
    body.customImage = data.get("customImage");
    body.customImageCheck = true;
  } else if (data.get("image")) {
    const field = IMAGE_GROUPS[body.serverType] || "image";
    body[field] = data.get("image");
  }
  if (config.imagePullPolicy && config.imagePullPolicy.value
      && data.get("imagePullPolicy")) {
    body.imagePullPolicy = data.get("imagePullPolicy");
  }
  const accelerator = data.get("gpuAccelerator");
  if (accelerator) {
    body.gpus = { accelerator };
    const gpus = parseInt(data.get("gpuCount"), 10);
    if (gpus > 0) body.gpus.gpus = gpus;
    const slices = parseInt(data.get("gpuSlices"), 10);
    if (slices > 1) body.gpus.slices = slices;
  }
  const workspace = data.get("workspace");
  if (workspace === "none") {
    body.workspaceVolume = null;
  } else if (workspace === "custom") {
    body.workspaceVolume = {
      mount: "/home/jovyan",
      newPvc: {
        metadata: { name: data.get("workspaceName") || "{notebook-name}-workspace" },
        spec: {
          resources: { requests: { storage: data.get("workspaceSize") || "10Gi" } },
          accessModes: ["ReadWriteOnce"],
        },
      },
    };
  }
  const dataVolumes = [];
  for (const row of volumeRows) {
    if (row.typeSel.value === "existing") {
      if (!row.pvcSel.value) continue;
      dataVolumes.push({
        mount: row.mountIn.value,
        existingSource: { persistentVolumeClaim: { claimName: row.pvcSel.value } },
      });
    } else {
      if (!row.nameIn.value) continue;
      dataVolumes.push({
        mount: row.mountIn.value,
        newPvc: {
          metadata: { name: row.nameIn.value },
          spec: {
            resources: { requests: { storage: row.sizeIn.value || "10Gi" } },
            accessModes: ["ReadWriteOnce"],
          },
        },
      });
    }
  }
  if (dataVolumes.length) body.dataVolumes = dataVolumes;
  const affinity = document.getElementById("affinity-select").value;
  if (affinity) body.affinityConfig = affinity;
  const tolerations = document.getElementById("toleration-select").value;
  if (tolerations) body.tolerationGroup = tolerations;
  return body;
}

function wireSpawner() {
  const dialog = document.getElementById("spawner");
  document.getElementById("gpu-acc").addEventListener("change", syncGpuCounts);
  /* Slice count changes the aggregate GPU ask: re-derive over-quota state. */
  document.getElementById("gpu-slices").addEventListener("change", syncGpuCounts);
  document.getElementById("workspace-select").addEventListener("change", (ev) => {
    document.getElementById("workspace-custom-row").hidden = ev.target.value !== "custom";
  });
  document.getElementById("add-volume").addEventListener("click", () => addVolumeRow());
  document.getElementById("new-notebook").addEventListener("click", () => {
    loadGpus();
    loadPoddefaults();
    loadExistingPvcs();
    // Re-apply config defaults a form.reset() reverted to HTML attributes.
    document.getElementById("shm-check").checked = !!(config.shm && config.shm.value);
    const cpu = document.querySelector("[name=cpu]");
    const memory = document.querySelector("[name=memory]");
    if (!cpu.disabled) cpu.value = config.cpu.value;
    if (!memory.disabled) memory.value = config.memory.value;
    const pullPolicy = document.getElementById("image-pull-policy");
    if (config.imagePullPolicy && config.imagePullPolicy.value && !pullPolicy.disabled) {
      pullPolicy.value = config.imagePullPolicy.value;
    }
    dialog.showModal();
  });
  document.getElementById("spawn-cancel").addEventListener("click", () => dialog.close());
  document.getElementById("spawn-form").addEventListener("submit", async (ev) => {
    ev.preventDefault();
    // Double-submit guard: a second Launch click while the POST is in
    // flight would create a duplicate-name conflict (reference disables
    // the submit button the same way).
    const launch = document.getElementById("spawn-submit");
    if (launch.disabled) return;
    launch.disabled = true;
    try {
      const body = spawnBody(ev.target);
      await api(`/api/namespaces/${ns}/notebooks`, {
        method: "POST",
        body: JSON.stringify(body),
      });
      toast("Launching " + body.name);
      dialog.close();
      ev.target.reset();
      clearVolumeRows();
      refreshTable();
    } catch (e) {
      toast(e.message, true);
    } finally {
      launch.disabled = false;
    }
  });
}

/* -- table ---------------------------------------------------------------- */

function renderNbRow(nb) {
  const stopped = nb.status && nb.status.phase === "stopped";
  const gpuText = nb.gpu
    ? `${nb.gpu.accelerator}${nb.gpu.gpus ? " × " + nb.gpu.gpus : ""}`
    : "—";
  return el("tr", {},
    el("td", {}, statusDot((nb.status && nb.status.phase) || "waiting")),
    el("td", {}, el("a", {
      href: `?ns=${ns}&nb=${nb.name}`,
      class: "nb-name",
      onclick: (ev) => { ev.preventDefault(); showDetail(nb.name); },
    }, nb.name)),
    el("td", { class: "mono", title: nb.image }, nb.shortImage),
    el("td", {}, gpuText),
    el("td", {}, nb.cpu || "—"),
    el("td", {}, nb.memory || "—"),
    el("td", {}, age(nb.age)),
    el("td", {},
      el("a", { class: "button ghost", href: connectUrl(nb), target: "_blank" }, "Connect"),
      el("button", {
        class: "ghost",
        onclick: () => toggleStop(nb, !stopped),
      }, stopped ? "Start" : "Stop"),
      el("button", {
        class: "danger",
        onclick: () => removeNotebook(nb),
      }, "Delete"),
    ),
  );
}

let nbTable = null;

function ensureNbTable() {
  if (!nbTable) {
    nbTable = tableView({
      table: document.getElementById("nb-table"),
      filterInput: document.getElementById("nb-filter"),
      pager: document.getElementById("nb-pager"),
      renderRow: renderNbRow,
      filterText: (nb) => [nb.name, nb.image,
                           (nb.status && nb.status.phase) || ""].join(" "),
      columns: {
        status: (nb) => (nb.status && nb.status.phase) || "",
        name: (nb) => nb.name || "",
        image: (nb) => nb.shortImage || nb.image || "",
        gpu: (nb) => nb.gpu
          ? `${nb.gpu.accelerator} ${nb.gpu.gpus || ""}` : "",
        cpu: (nb) => parseQuantity(nb.cpu),
        memory: (nb) => parseQuantity(nb.memory),
        age: (nb) => nb.age || "",
      },
    });
  }
  return nbTable;
}

let refreshSeq = 0;

async function refreshTable() {
  // Stale-response guard: a poll refresh can overlap a user-triggered one
  // and arrive LAST with OLDER data; only the newest request may render.
  const seq = ++refreshSeq;
  let notebooks = [];
  try {
    notebooks = (await api(`/api/namespaces/${ns}/notebooks`)).notebooks;
  } catch (e) {
    toast(e.message, true);
    return;
  }
  if (seq !== refreshSeq) return;
  document.getElementById("nb-empty").hidden = notebooks.length > 0;
  ensureNbTable().setRows(notebooks);
}

async function toggleStop(nb, stop) {
  try {
    await api(`/api/namespaces/${ns}/notebooks/${nb.name}`, {
      method: "PATCH",
      body: JSON.stringify({ stopped: stop }),
    });
    toast((stop ? "Stopping " : "Starting ") + nb.name);
    refreshTable();
  } catch (e) {
    toast(e.message, true);
  }
}

async function removeNotebook(nb) {
  if (!confirmDialog(`Delete notebook ${nb.name}? Its workspace PVC is kept.`)) return;
  try {
    await api(`/api/namespaces/${ns}/notebooks/${nb.name}`, { method: "DELETE" });
    toast("Deleted " + nb.name);
    refreshTable();
  } catch (e) {
    toast(e.message, true);
  }
}

/* -- detail page (overview / logs / events / manifest) ------------------------ */

function selectTab(tab) {
  for (const a of document.querySelectorAll("#detail-tabs a")) {
    a.classList.toggle("active", a.dataset.tab === tab);
  }
  for (const name of ["overview", "logs", "events", "manifest"]) {
    document.getElementById("tab-" + name).hidden = name !== tab;
  }
  if (tab === "logs") loadPods().then(loadLogs).catch((e) => toast(e.message, true));
  if (tab === "events") loadEvents().catch((e) => toast(e.message, true));
}

async function showDetail(name) {
  detailName = name;
  document.getElementById("view-table").hidden = true;
  document.getElementById("view-detail").hidden = false;
  document.getElementById("detail-title").textContent = name;
  document.getElementById("detail-connect").href = `/notebook/${ns}/${name}/`;
  selectTab("overview");
  try {
    await refreshDetail();
  } catch (e) {
    toast(e.message, true);
  }
}

function backToTable() {
  detailName = null;
  document.getElementById("view-detail").hidden = true;
  document.getElementById("view-table").hidden = false;
  refreshTable();
}

async function refreshDetail() {
  const nb = (await api(`/api/namespaces/${ns}/notebooks/${detailName}`)).notebook;
  const spec = ((nb.spec || {}).template || {}).spec || {};
  const container = (spec.containers || [{}])[0];
  const resources = container.resources || {};
  const requests = resources.requests || {};
  const gpu = (nb.spec || {}).gpu;
  const list = document.getElementById("overview-list");
  list.replaceChildren();
  const add = (k, v) => list.append(el("dt", {}, k), el("dd", {}, v));
  add("Image", container.image || "—");
  add("GPU", gpu
    ? `${gpu.accelerator}${gpu.gpus ? " × " + gpu.gpus : ""}` +
      (gpu.slices > 1 ? ` × ${gpu.slices} slices` : "")
    : "none");
  add("CPU", requests.cpu || "—");
  add("Memory", requests.memory || "—");
  add("Created", (nb.metadata || {}).creationTimestamp
    ? age((nb.metadata || {}).creationTimestamp) + " ago" : "—");
  add("Volumes", (spec.volumes || []).map((v) => v.name).join(", ") || "none");
  const conditions = (nb.status || {}).conditions || [];
  const tbody = document.querySelector("#cond-table tbody");
  tbody.replaceChildren();
  for (const c of conditions) {
    tbody.append(el("tr", {},
      el("td", {}, c.type || ""), el("td", {}, c.status || ""),
      el("td", {}, c.reason || ""), el("td", {}, c.message || "")));
  }
  document.getElementById("manifest-output").textContent = toManifest(nb);
}

async function loadPods() {
  const select = document.getElementById("log-pod-select");
  select.replaceChildren();
  try {
    const out = await api(`/api/namespaces/${ns}/notebooks/${detailName}/pod`);
    for (const pod of out.pods || []) {
      select.append(el("option", { value: pod }, pod));
    }
  } catch (e) {
    document.getElementById("log-output").textContent =
      "No pods (notebook may be stopped or still scheduling).";
    throw e;
  }
}

async function loadLogs() {
  const pod = document.getElementById("log-pod-select").value;
  if (!pod) return;
  try {
    const out = await api(
      `/api/namespaces/${ns}/notebooks/${detailName}/pod/${pod}/logs`);
    document.getElementById("log-output").textContent = out.logs.join("\n");
  } catch (e) {
    document.getElementById("log-output").textContent = e.message;
  }
}

async function loadEvents() {
  const out = await api(`/api/namespaces/${ns}/notebooks/${detailName}/events`);
  const events = out.events || [];
  document.getElementById("ev-empty").hidden = events.length > 0;
  const tbody = document.querySelector("#ev-table tbody");
  tbody.replaceChildren();
  for (const ev of events) {
    tbody.append(el("tr", {},
      el("td", {}, age(ev.lastTimestamp || ev.firstTimestamp)),
      el("td", {}, ev.type || ""),
      el("td", {}, ev.reason || ""),
      el("td", {}, ev.message || "")));
  }
}

/* Minimal YAML rendering of the CR for the manifest tab (reference shows the
   object as YAML; JSON in, YAML out — strings quoted only when needed). */
const MANIFEST_NEEDS_QUOTES = new RegExp(
  "[:#\\[\\]{}&*!|>'\"%@`]|^\\s|\\s$|^-" +
  // Any number-like string (int/float/exponent) must quote or it changes
  // type on re-parse ("1.5" label -> 1.5 number).
  "|^[+]?(\\d+\\.?\\d*|\\.\\d+)([eE][+-]?\\d+)?$" +
  "|^(true|false|null)$");

function manifestScalar(v) {
  if (v === null || v === undefined) return "null";
  if (typeof v === "boolean" || typeof v === "number") return String(v);
  const s = String(v);
  if (s === "" || MANIFEST_NEEDS_QUOTES.test(s)) return JSON.stringify(s);
  return s;
}

function toManifest(v, indent = "") {
  if (Array.isArray(v)) {
    if (!v.length) return indent + "[]";
    return v.map((item) => {
      if (item && typeof item === "object") {
        const body = toManifest(item, indent + "  ");
        return indent + "- " + body.slice(indent.length + 2);
      }
      return indent + "- " + manifestScalar(item);
    }).join("\n");
  }
  if (v && typeof v === "object") {
    const keys = Object.keys(v);
    if (!keys.length) return indent + "{}";
    return keys.map((k) => {
      const item = v[k];
      if (Array.isArray(item)) {
        return item.length
          ? indent + k + ":\n" + toManifest(item, indent + "  ")
          : indent + k + ": []";
      }
      if (item && typeof item === "object") {
        return Object.keys(item).length
          ? indent + k + ":\n" + toManifest(item, indent + "  ")
          : indent + k + ": {}";
      }
      return indent + k + ": " + manifestScalar(item);
    }).join("\n");
  }
  return indent + manifestScalar(v);
}

/* -- wiring --------------------------------------------------------------- */

document.getElementById("detail-back").addEventListener("click", backToTable);
for (const a of document.querySelectorAll("#detail-tabs a")) {
  a.addEventListener("click", (ev) => {
    ev.preventDefault();
    selectTab(a.dataset.tab);
  });
}
document.getElementById("logs-refresh").addEventListener("click", () => {
  loadLogs();
});
document.getElementById("log-pod-select").addEventListener("change", () => {
  loadLogs();
});

loadConfig().then(() => {
  wireSpawner();
  // poll() runs its callback immediately, so no extra initial refresh.
  poll(() => {
    if (detailName === null) refreshTable();
  }, 10000);
  const deepLink = new URLSearchParams(window.location.search).get("nb");
  if (deepLink) showDetail(deepLink);
}).catch((e) => toast(e.message, true));
