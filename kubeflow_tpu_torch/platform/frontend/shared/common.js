/* Shared SPA helpers: API fetch with the CSRF double-submit header, the
   namespace query param convention (?ns=, kept in sync with the dashboard
   shell), toasts, and small DOM utilities. */

export function getCookie(name) {
  const m = document.cookie.match(new RegExp("(?:^|; )" + name + "=([^;]*)"));
  return m ? decodeURIComponent(m[1]) : null;
}

export async function api(path, opts = {}) {
  const headers = Object.assign(
    { "Content-Type": "application/json" },
    opts.headers || {}
  );
  const method = (opts.method || "GET").toUpperCase();
  if (!["GET", "HEAD", "OPTIONS"].includes(method)) {
    const token = getCookie("XSRF-TOKEN");
    if (token) headers["X-XSRF-TOKEN"] = token;
  }
  const resp = await fetch(path, Object.assign({}, opts, { headers }));
  let body = null;
  try {
    body = await resp.json();
  } catch (e) {
    /* non-JSON error page */
  }
  if (!resp.ok || (body && body.success === false)) {
    const msg = (body && (body.user_action || body.log)) || resp.statusText;
    const err = new Error(msg);
    err.status = resp.status;  // callers branch on 404/405 vs transient
    throw err;
  }
  return body;
}

export function namespace() {
  return new URLSearchParams(window.location.search).get("ns") || "kubeflow-user";
}

export function setNamespace(ns) {
  const url = new URL(window.location);
  url.searchParams.set("ns", ns);
  window.history.replaceState({}, "", url);
}

export function el(tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "class") node.className = v;
    else if (k.startsWith("on")) node.addEventListener(k.slice(2), v);
    else if (v !== null && v !== undefined) node.setAttribute(k, v);
  }
  for (const child of children.flat()) {
    node.append(child instanceof Node ? child : document.createTextNode(String(child)));
  }
  return node;
}

/* Kubernetes quantity ("512Mi", "1Gi", "2", "500m") -> number for sorting. */
export function parseQuantity(raw) {
  if (raw === null || raw === undefined) return 0;
  const m = String(raw).trim().match(new RegExp("^([0-9.]+)([A-Za-z]*)$"));
  if (!m) return 0;
  const units = {
    "": 1, m: 1e-3, k: 1e3, K: 1e3, M: 1e6, G: 1e9, T: 1e12, P: 1e15,
    Ki: 1024, Mi: 1024 ** 2, Gi: 1024 ** 3, Ti: 1024 ** 4, Pi: 1024 ** 5,
  };
  const scale = units[m[2]];
  return scale === undefined ? 0 : parseFloat(m[1]) * scale;
}

const SVG_NS = "http://www.w3.org/2000/svg";

/* SVG sibling of el(): createElementNS so the elements actually paint in
   a real browser (createElement("svg") would not). */
export function svgEl(tag, attrs = {}, ...children) {
  const node = document.createElementNS(SVG_NS, tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (v !== null && v !== undefined) node.setAttribute(k, v);
  }
  for (const child of children.flat()) {
    node.append(child instanceof Node ? child : document.createTextNode(String(child)));
  }
  return node;
}

let toastTimer = null;
export function toast(message, isError = false) {
  let box = document.getElementById("toast");
  if (!box) {
    box = el("div", { id: "toast" });
    document.body.append(box);
  }
  box.textContent = message;
  box.className = "show" + (isError ? " error" : "");
  clearTimeout(toastTimer);
  toastTimer = setTimeout(() => (box.className = ""), 4000);
}

export function statusDot(phase) {
  return el("span", { class: "status" },
    el("span", { class: "dot " + phase }),
    el("span", {}, phase));
}

export function age(timestamp) {
  if (!timestamp) return "";
  const s = Math.max(0, (Date.now() - new Date(timestamp).getTime()) / 1000);
  if (s < 90) return Math.round(s) + "s";
  if (s < 5400) return Math.round(s / 60) + "m";
  if (s < 129600) return Math.round(s / 3600) + "h";
  return Math.round(s / 86400) + "d";
}

export function confirmDialog(text) {
  return window.confirm(text);
}

/* Client-side resource-table controller: sorting (click a th[data-sort]),
   text filtering, and pagination — the shared behaviors the reference's
   kubeflow-common-lib resource-table component gives every CRUD app
   (reference resource-table.component.ts).  The app owns fetching and row
   rendering; this owns view state. */
export function tableView(opts) {
  // opts: { table, renderRow, filterText, filterInput?, pager?,
  //         columns?: {key: accessor}, pageSize? }
  const state = { rows: [], sortKey: null, sortDir: 1, page: 0 };
  const pageSize = opts.pageSize || 10;
  const ths = opts.table.querySelectorAll("th[data-sort]");
  for (const th of ths) {
    th.addEventListener("click", () => {
      const key = th.dataset.sort;
      if (state.sortKey === key) {
        state.sortDir = -state.sortDir;
      } else {
        state.sortKey = key;
        state.sortDir = 1;
      }
      render();
    });
  }
  if (opts.filterInput) {
    opts.filterInput.addEventListener("input", () => {
      state.page = 0;
      render();
    });
  }

  function visible() {
    let rows = state.rows.slice();
    const q = opts.filterInput
      ? opts.filterInput.value.trim().toLowerCase() : "";
    if (q && opts.filterText) {
      rows = rows.filter((r) => opts.filterText(r).toLowerCase().includes(q));
    }
    if (state.sortKey && opts.columns && opts.columns[state.sortKey]) {
      const acc = opts.columns[state.sortKey];
      rows.sort((a, b) => {
        const va = acc(a);
        const vb = acc(b);
        if (va < vb) return -state.sortDir;
        if (va > vb) return state.sortDir;
        return 0;
      });
    }
    return rows;
  }

  function render() {
    const rows = visible();
    const pages = Math.max(1, Math.ceil(rows.length / pageSize));
    if (state.page >= pages) state.page = pages - 1;
    if (state.page < 0) state.page = 0;
    const start = state.page * pageSize;
    const pageRows = rows.slice(start, start + pageSize);
    const tbody = opts.table.querySelector("tbody");
    tbody.replaceChildren();
    for (const r of pageRows) tbody.append(opts.renderRow(r));
    for (const th of ths) {
      th.classList.remove("sort-asc", "sort-desc");
      if (th.dataset.sort === state.sortKey) {
        th.classList.add(state.sortDir > 0 ? "sort-asc" : "sort-desc");
      }
    }
    if (opts.pager) {
      opts.pager.replaceChildren();
      if (rows.length > pageSize || state.rows.length > pageSize) {
        const prev = el("button", { class: "ghost pager-prev" }, "‹");
        const next = el("button", { class: "ghost pager-next" }, "›");
        if (state.page <= 0) prev.disabled = true;
        if (state.page >= pages - 1) next.disabled = true;
        prev.addEventListener("click", () => { state.page--; render(); });
        next.addEventListener("click", () => { state.page++; render(); });
        const label = rows.length
          ? `${start + 1}–${Math.min(start + pageSize, rows.length)} of ${rows.length}`
          : "0 of 0";
        opts.pager.append(prev, el("span", { class: "pager-label" }, label), next);
      }
    }
    return rows.length;
  }

  return {
    setRows(rows) {
      state.rows = rows || [];
      return render();
    },
    render,
  };
}

/* Poll helper: run fn now and on an interval; pause while the tab is hidden. */
export function poll(fn, ms) {
  fn();
  const timer = setInterval(() => {
    if (!document.hidden) fn();
  }, ms);
  return () => clearInterval(timer);
}
