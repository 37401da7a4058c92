/* Volumes SPA: PVC table with mount usage, create + guarded delete. */
import {
  api, namespace, el, toast, statusDot, age, poll, confirmDialog, tableView,
  parseQuantity,
} from "./shared/common.js";

const ns = namespace();
document.getElementById("ns-label").textContent = "namespace: " + ns;

const PHASES = { Bound: "ready", Pending: "waiting", Lost: "warning" };

function renderPvcRow(pvc) {
  return el("tr", {},
    el("td", {}, statusDot(PHASES[pvc.status] || "waiting")),
    el("td", {}, el("a", {
      href: `?ns=${ns}&pvc=${pvc.name}`,
      class: "pvc-name",
      onclick: (ev) => { ev.preventDefault(); showDetail(pvc.name); },
    }, pvc.name)),
    el("td", {}, pvc.capacity),
    el("td", {}, (pvc.modes || []).join(", ")),
    el("td", {}, pvc.class || "default"),
    el("td", { class: "mono" }, (pvc.usedBy || []).join(", ") || "—"),
    el("td", {}, age(pvc.age)),
    el("td", {}, el("button", {
      class: "danger",
      disabled: (pvc.usedBy || []).length ? "" : null,
      title: (pvc.usedBy || []).length ? "mounted by a pod" : "",
      onclick: () => remove(pvc),
    }, "Delete")),
  );
}

let pvcTable = null;

function ensurePvcTable() {
  if (!pvcTable) {
    pvcTable = tableView({
      table: document.getElementById("pvc-table"),
      filterInput: document.getElementById("pvc-filter"),
      pager: document.getElementById("pvc-pager"),
      renderRow: renderPvcRow,
      filterText: (pvc) => [pvc.name, pvc.status || "",
                            (pvc.usedBy || []).join(" ")].join(" "),
      columns: {
        status: (pvc) => pvc.status || "",
        name: (pvc) => pvc.name || "",
        size: (pvc) => parseQuantity(pvc.capacity),
        age: (pvc) => pvc.age || "",
      },
    });
  }
  return pvcTable;
}

async function refresh() {
  let pvcs = [];
  try {
    pvcs = (await api(`/api/namespaces/${ns}/pvcs`)).pvcs;
  } catch (e) {
    toast(e.message, true);
    return;
  }
  document.getElementById("pvc-empty").hidden = pvcs.length > 0;
  ensurePvcTable().setRows(pvcs);
}

async function remove(pvc) {
  if (!confirmDialog(`Delete volume ${pvc.name}? Data is lost permanently.`)) return;
  try {
    await api(`/api/namespaces/${ns}/pvcs/${pvc.name}`, { method: "DELETE" });
    toast("Deleted " + pvc.name);
    refresh();
  } catch (e) {
    toast(e.message, true);
  }
}

/* -- volume details (reference volume-details-page) ----------------------- */

let detailName = null;

async function showDetail(name) {
  detailName = name;
  document.getElementById("view-table").hidden = true;
  document.getElementById("view-detail").hidden = false;
  document.getElementById("detail-title").textContent = name;
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
  refresh();
}

async function refreshDetail() {
  const pvc = (await api(`/api/namespaces/${ns}/pvcs/${detailName}`)).pvc;
  const spec = pvc.spec || {};
  const list = document.getElementById("detail-list");
  list.replaceChildren();
  const add = (k, v) => list.append(el("dt", {}, k), el("dd", {}, v));
  add("Status", ((pvc.status || {}).phase) || "Pending");
  add("Size", (((spec.resources || {}).requests || {}).storage) || "—");
  add("Access modes", (spec.accessModes || []).join(", ") || "—");
  add("Storage class", spec.storageClassName || "cluster default");
  add("Created", (pvc.metadata || {}).creationTimestamp
    ? age((pvc.metadata || {}).creationTimestamp) + " ago" : "—");

  const pods = (await api(`/api/namespaces/${ns}/pvcs/${detailName}/pods`)).pods;
  document.getElementById("detail-pods-empty").hidden = pods.length > 0;
  const ptbody = document.querySelector("#detail-pods-table tbody");
  ptbody.replaceChildren();
  for (const pod of pods) {
    ptbody.append(el("tr", {},
      el("td", { class: "mono" }, pod.name),
      el("td", {}, pod.phase),
      el("td", { class: "mono" }, pod.mountPath || "—")));
  }

  const events = (await api(`/api/namespaces/${ns}/pvcs/${detailName}/events`)).events;
  document.getElementById("detail-ev-empty").hidden = events.length > 0;
  const etbody = document.querySelector("#detail-ev-table tbody");
  etbody.replaceChildren();
  for (const ev of events) {
    etbody.append(el("tr", {},
      el("td", {}, age(ev.lastTimestamp || ev.firstTimestamp)),
      el("td", {}, ev.type || ""),
      el("td", {}, ev.reason || ""),
      el("td", {}, ev.message || "")));
  }
}

document.getElementById("detail-back").addEventListener("click", backToTable);

async function loadClasses() {
  try {
    const classes = (await api("/api/storageclasses")).storageClasses;
    const select = document.getElementById("class-select");
    for (const c of classes) select.append(el("option", { value: c }, c));
  } catch (e) { /* listing may be forbidden; default remains */ }
}

const dialog = document.getElementById("creator");
document.getElementById("new-pvc").addEventListener("click", () => dialog.showModal());
document.getElementById("create-cancel").addEventListener("click", () => dialog.close());
document.getElementById("create-form").addEventListener("submit", async (ev) => {
  ev.preventDefault();
  const data = new FormData(ev.target);
  try {
    await api(`/api/namespaces/${ns}/pvcs`, {
      method: "POST",
      body: JSON.stringify({
        name: data.get("name"),
        size: data.get("size"),
        mode: data.get("mode"),
        class: data.get("class"),
      }),
    });
    toast("Created " + data.get("name"));
    dialog.close();
    ev.target.reset();
    refresh();
  } catch (e) {
    toast(e.message, true);
  }
});

loadClasses();
// poll() runs its callback immediately, so no extra initial refresh.
poll(() => {
  if (detailName === null) refresh();
}, 10000);
const deepLink = new URLSearchParams(window.location.search).get("pvc");
if (deepLink) showDetail(deepLink);
