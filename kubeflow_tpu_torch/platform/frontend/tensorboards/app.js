/* TensorBoards SPA: CR table + create/delete, connect via VirtualService path. */
import {
  api, namespace, el, toast, statusDot, age, poll, confirmDialog,
} from "./shared/common.js";

const ns = namespace();
document.getElementById("ns-label").textContent = "namespace: " + ns;

async function refresh() {
  let tbs = [];
  try {
    tbs = (await api(`/api/namespaces/${ns}/tensorboards`)).tensorboards;
  } catch (e) {
    toast(e.message, true);
    return;
  }
  const tbody = document.querySelector("#tb-table tbody");
  document.getElementById("tb-empty").hidden = tbs.length > 0;
  tbody.replaceChildren();
  for (const tb of tbs) {
    tbody.append(el("tr", {},
      el("td", {}, statusDot(tb.ready ? "ready" : "waiting")),
      el("td", {}, el("a", {
        href: `/tensorboard/${ns}/${tb.name}/`, target: "_blank",
      }, tb.name)),
      el("td", { class: "mono" }, tb.logspath),
      el("td", {}, age(tb.age)),
      el("td", {}, el("button", {
        class: "danger", onclick: () => remove(tb),
      }, "Delete")),
    ));
  }
}

async function remove(tb) {
  if (!confirmDialog(`Delete TensorBoard ${tb.name}?`)) return;
  try {
    await api(`/api/namespaces/${ns}/tensorboards/${tb.name}`, { method: "DELETE" });
    toast("Deleted " + tb.name);
    refresh();
  } catch (e) {
    toast(e.message, true);
  }
}

const dialog = document.getElementById("creator");
document.getElementById("new-tb").addEventListener("click", () => dialog.showModal());
document.getElementById("create-cancel").addEventListener("click", () => dialog.close());
document.getElementById("create-form").addEventListener("submit", async (ev) => {
  ev.preventDefault();
  const data = new FormData(ev.target);
  try {
    await api(`/api/namespaces/${ns}/tensorboards`, {
      method: "POST",
      body: JSON.stringify({
        name: data.get("name"),
        logspath: data.get("logspath"),
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

poll(refresh, 10000);
