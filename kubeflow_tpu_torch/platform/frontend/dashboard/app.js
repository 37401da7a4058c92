/* Central dashboard shell: namespace selector, sidebar navigation that
   iframes the child apps (reference main-page.js + iframe-container.js),
   overview cards, activity feed, contributor management. */
import { api, el, svgEl, toast, age } from "./shared/common.js";

let envInfo = null;
let currentNs = null;

const frame = document.getElementById("app-frame");
const views = {
  home: document.getElementById("view-home"),
  contributors: document.getElementById("view-contributors"),
};

function show(view, href) {
  for (const main of Object.values(views)) main.hidden = true;
  frame.hidden = true;
  if (view && views[view]) {
    views[view].hidden = false;
    if (view === "contributors") loadContributors();
  } else if (href) {
    frame.hidden = false;
    const url = new URL(href, window.location.origin);
    url.searchParams.set("ns", currentNs || "");
    frame.src = url.href;  // absolute: links may be cross-origin (demo topology)
  }
  for (const a of document.querySelectorAll("nav.sidebar a")) {
    a.classList.toggle("active", a.dataset.view === view || (!view && a.dataset.href === href));
  }
}

async function loadEnvInfo() {
  envInfo = await api("/api/workgroup/env-info");
  document.getElementById("user-label").textContent = envInfo.user || "";
  const select = document.getElementById("ns-select");
  const previous = currentNs;
  select.replaceChildren();
  for (const item of envInfo.namespaces || []) {
    select.append(el("option", { value: item.namespace }, `${item.namespace} (${item.role})`));
  }
  // Idempotent: keep the user's selection across refreshes (a contributor
  // mutation must not silently retarget another namespace).
  if (previous && [...select.options].some((o) => o.value === previous)) {
    select.value = previous;
  }
  currentNs = select.value || null;
  document.getElementById("stat-namespaces").textContent =
    String((envInfo.namespaces || []).length);
  document.getElementById("register-card").hidden = envInfo.hasWorkgroup;
}

document.getElementById("ns-select").addEventListener("change", (ev) => {
  currentNs = ev.target.value;
  refreshHome();
  if (!views.contributors.hidden) loadContributors();
  if (!frame.hidden && frame.src) {
    const url = new URL(frame.src);
    url.searchParams.set("ns", currentNs);
    frame.src = url.href;
  }
});

async function loadLinks() {
  const links = (await api("/api/dashboard-links")).links;
  const sidebar = document.getElementById("sidebar");
  const anchor = sidebar.querySelector("[data-view=contributors]");
  for (const item of (links.menuLinks || [])) {
    const a = el("a", { href: "#", "data-href": item.link }, item.text);
    a.addEventListener("click", (ev) => {
      ev.preventDefault();
      show(null, item.link);
    });
    sidebar.insertBefore(a, anchor);
  }
}

async function refreshHome() {
  try {
    const overview = await api(
      `/api/gpu-overview?ns=${encodeURIComponent(currentNs || "")}`);
    document.getElementById("stat-capacity").textContent =
      String(overview.clusterCapacityGPUs);
    const requested = Object.values(overview.requestedGPUsByNamespace || {})
      .reduce((a, b) => a + b, 0);
    document.getElementById("stat-requested").textContent = String(requested);
    // Namespace GPU budget: same accounting as the spawner picker, so
    // the card and the picker can never disagree about "remaining".
    const card = document.getElementById("quota-card");
    if (overview.quota) {
      card.hidden = false;
      document.getElementById("quota-card-title").textContent =
        `GPU quota (${currentNs})`;
      document.getElementById("stat-quota").textContent =
        `${overview.quota.remaining} of ${overview.quota.hard} GPUs free`;
    } else {
      card.hidden = true;
    }
  } catch (e) { /* nodes may be unlistable for plain users */ }
  if (!currentNs) return;
  try {
    const events = (await api(`/api/activities/${currentNs}`)).events;
    const tbody = document.querySelector("#activity-table tbody");
    document.getElementById("activity-empty").hidden = events.length > 0;
    tbody.replaceChildren();
    for (const ev of events.slice(0, 25)) {
      tbody.append(el("tr", {},
        el("td", {}, age(ev.lastTimestamp) || ""),
        el("td", { class: "mono" },
          `${(ev.involvedObject || {}).kind || ""}/${(ev.involvedObject || {}).name || ""}`),
        el("td", {}, ev.reason || ""),
        el("td", {}, ev.message || ""),
      ));
    }
  } catch (e) { /* no access yet */ }
}

/* Time-series chart over /api/metrics/<type> (reference
   resource-chart.js): one polyline per label (node/pod), min/max y-axis
   labels, legend.  Hidden entirely when no metrics service is wired
   (the backend 405s). */
const SERIES_COLORS = ["#1967d2", "#d93025", "#188038", "#f9ab00",
                       "#9334e6", "#12a4af"];
let metricsAvailable = true;
let metricsProbed = false;

async function loadMetrics() {
  if (!metricsAvailable) return;
  const card = document.getElementById("metrics-card");
  const type = document.getElementById("metric-type").value;
  const interval = document.getElementById("metric-interval").value;
  let points = [];
  try {
    points = (await api(`/api/metrics/${type}?interval=${interval}`)).points;
  } catch (e) {
    if (!metricsProbed && e.status === 405) {
      // Initial probe says no metrics service is wired — only the 405 the
      // backend reserves for that may hide the card for the session.  Any
      // OTHER initial failure (transient 500, a 501 type-unsupported from
      // a wired service, network blip) must not latch: show the empty
      // state and let the next poll/selector change retry (advisor r3).
      metricsAvailable = false;
      card.hidden = true;
    } else {
      card.hidden = false;
      renderChart([]);
      toast(e.message, true);
    }
    // Any settled request completes the probe: a LATER per-type 404/405
    // (e.g. after a transient first failure) means "this type is
    // unsupported", never "no service" — it must not latch the card.
    metricsProbed = true;
    return;
  }
  metricsProbed = true;
  card.hidden = false;
  renderChart(points || []);
}

function renderChart(points) {
  const svg = document.getElementById("metric-chart");
  const legend = document.getElementById("metric-legend");
  svg.replaceChildren();
  legend.replaceChildren();
  document.getElementById("metrics-empty").hidden = points.length > 0;
  if (!points.length) return;
  const W = 600, H = 200, PAD = 36;
  let t0 = points[0].timestamp, t1 = t0, v0 = points[0].value, v1 = v0;
  for (const p of points) {
    if (p.timestamp < t0) t0 = p.timestamp;
    if (p.timestamp > t1) t1 = p.timestamp;
    if (p.value < v0) v0 = p.value;
    if (p.value > v1) v1 = p.value;
  }
  if (v1 === v0) v1 = v0 + 1;
  const x = (t) => PAD + (t1 === t0 ? 0 : (t - t0) / (t1 - t0)) * (W - 2 * PAD);
  const y = (v) => (H - PAD) - (v - v0) / (v1 - v0) * (H - 2 * PAD);
  svg.append(
    svgEl("line", { x1: PAD, y1: H - PAD, x2: W - PAD, y2: H - PAD,
                    stroke: "#999" }),
    svgEl("line", { x1: PAD, y1: PAD, x2: PAD, y2: H - PAD, stroke: "#999" }),
    svgEl("text", { x: 2, y: PAD + 4, class: "axis-label" }, v1.toFixed(2)),
    svgEl("text", { x: 2, y: H - PAD, class: "axis-label" }, v0.toFixed(2)),
  );
  const series = {};
  for (const p of points) {
    (series[p.label] = series[p.label] || []).push(p);
  }
  Object.keys(series).forEach((label, i) => {
    const color = SERIES_COLORS[i % SERIES_COLORS.length];
    const path = series[label]
      .slice()
      .sort((a, b) => a.timestamp - b.timestamp)
      .map((p) => `${x(p.timestamp).toFixed(1)},${y(p.value).toFixed(1)}`)
      .join(" ");
    svg.append(svgEl("polyline", {
      points: path, fill: "none", stroke: color, "stroke-width": 1.5,
      "data-series": label,
    }));
    legend.append(el("span", { class: "legend-item" },
      el("span", { class: "legend-swatch", style: `background:${color}` }),
      label));
  });
}

async function loadContributors() {
  document.getElementById("contrib-ns").textContent = currentNs || "—";
  const tbody = document.querySelector("#contrib-table tbody");
  tbody.replaceChildren();
  if (!currentNs) return;
  let contributors = [];
  try {
    contributors = (await api(`/api/workgroup/contributors/${currentNs}`)).contributors;
  } catch (e) {
    toast(e.message, true);
    return;
  }
  for (const item of contributors) {
    tbody.append(el("tr", {},
      el("td", {}, item.user),
      el("td", {}, item.role),
      el("td", {}, item.role === "contributor"
        ? el("button", { class: "danger", onclick: () => removeContributor(item.user) }, "Remove")
        : ""),
    ));
  }
}

async function removeContributor(user) {
  try {
    await api("/api/workgroup/remove-contributor", {
      method: "DELETE",
      body: JSON.stringify({ contributor: user, namespace: currentNs }),
    });
    toast("Removed " + user);
    await loadEnvInfo();
    loadContributors();
  } catch (e) {
    toast(e.message, true);
  }
}

document.getElementById("contrib-form").addEventListener("submit", async (ev) => {
  ev.preventDefault();
  const contributor = new FormData(ev.target).get("contributor");
  try {
    await api("/api/workgroup/add-contributor", {
      method: "POST",
      body: JSON.stringify({ contributor, namespace: currentNs }),
    });
    toast("Added " + contributor);
    ev.target.reset();
    await loadEnvInfo();
    loadContributors();
  } catch (e) {
    toast(e.message, true);
  }
});

document.getElementById("register-btn").addEventListener("click", async () => {
  try {
    const out = await api("/api/workgroup/create", { method: "POST", body: "{}" });
    toast("Created namespace " + out.namespace);
    await loadEnvInfo();
    refreshHome();
  } catch (e) {
    toast(e.message, true);
  }
});

for (const a of document.querySelectorAll("nav.sidebar a[data-view]")) {
  a.addEventListener("click", (ev) => {
    ev.preventDefault();
    show(a.dataset.view);
  });
}

document.getElementById("metric-type").addEventListener("change", loadMetrics);
document.getElementById("metric-interval").addEventListener("change", loadMetrics);

loadEnvInfo()
  .then(() => Promise.all([loadLinks(), refreshHome(), loadMetrics()]))
  .catch((e) => toast(e.message, true));
