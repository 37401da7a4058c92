"""The repo-native rule set (R001..R010), aimed at the port.

The port's copy of ``kubeflow_tpu/analysis/rules.py``: the same checks
and messages, scoped at ``kubeflow_tpu_torch/``.  Each rule encodes a
contract of the control plane; the rationale, an example finding and
the sanctioned fix live in ``docs/analysis.md``.  R003 also keeps
``torch``, ``triton`` and the JAX package out of the control plane's
import time.  Rules are deliberately *precise over complete*: a rule
that cries wolf on ``limits.update(...)`` (a dict, not a client) would
be suppressed into noise, so receivers are matched structurally.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from kubeflow_tpu_torch.analysis.engine import Finding, Rule, register

CONTROLLERS = "kubeflow_tpu_torch/platform/controllers/*.py"
RUNTIME = "kubeflow_tpu_torch/platform/runtime/*.py"


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``self.client.inner`` -> ["self", "client", "inner"]; None for
    receivers that are not plain Name/Attribute chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


WRITE_VERBS = {
    "create", "update", "patch", "delete", "update_status",
    "patch_status", "replace", "delete_collection",
}
CLIENT_CLASSES = {"RestKubeClient", "HttpKube", "FakeKube", "ChaosKube"}


@register
class FencedWrites(Rule):
    """R001: reconcile-path writes go through the controller's injected
    client (``self.client`` — the FencedClient when sharding is on) or the
    ``runtime.apply`` helpers.  A write on any *other* client-shaped
    receiver — ``.inner`` (the fence bypass), a locally constructed
    transport client, a sibling informer's client — escapes the fence and
    re-opens the split-brain double-write."""

    id = "R001"
    summary = ("reconcile-path writes must go through the injected "
               "self.client / apply.* helpers, never a raw client")
    scope = (CONTROLLERS,)

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in CLIENT_CLASSES:
                yield (node.lineno,
                       f"constructs {fn.id} inside a controller; clients "
                       "are wired in main.py and injected (fencing wraps "
                       "the injected one)")
                continue
            if not (isinstance(fn, ast.Attribute) and fn.attr in WRITE_VERBS):
                continue
            recv = fn.value
            if isinstance(recv, ast.Call):
                if _call_name(recv) in CLIENT_CLASSES:
                    yield (node.lineno,
                           f"write via inline {_call_name(recv)}() bypasses "
                           "the manager's FencedClient wiring")
                continue
            chain = _attr_chain(recv)
            if chain is None:
                continue
            if "inner" in chain:
                yield (node.lineno,
                       f"write via {'.'.join(chain)}.{fn.attr} bypasses the "
                       "write fence; use the fenced client itself")
                continue
            term = chain[-1].lower()
            if (("client" in term or "kube" in term)
                    and chain not in (["self", "client"], ["client"])):
                yield (node.lineno,
                       f"raw client write {'.'.join(chain)}.{fn.attr}(); "
                       "route through the injected self.client "
                       "(FencedClient) or runtime.apply helpers")


_INFORMERISH = ("informer", "cache", "lister")
_GETTERS = {"get", "list", "index_list"}
_MUTATORS = {
    "setdefault", "update", "pop", "popitem", "clear", "append",
    "extend", "insert", "remove", "sort", "reverse",
}


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@register
class FrozenViews(Rule):
    """R002: objects read from an informer cache are enforced-read-only
    frozen views (docs/performance.md "read-ownership contract"); writing
    into one without ``thaw()`` either raises at runtime or — worse, on a
    plain-dict test double — silently mutates the shared cache every other
    reader trusts.  Tracks names bound from ``*informer*/*cache*``
    ``get/list/index_list`` within a function and flags subscript/attribute
    stores and mutating method calls on them until they are re-bound
    (``thaw(obj)``, ``dict(obj)``, ``copy.deepcopy(obj)``...)."""

    id = "R002"
    summary = "informer-cached objects must be thaw()ed before mutation"
    scope = (CONTROLLERS, RUNTIME)

    def check(self, tree, text, path):
        out: List[Tuple[int, str]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(node, out)
        return out

    def _informerish(self, call: ast.Call) -> bool:
        fn = call.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in _GETTERS):
            return False
        chain = _attr_chain(fn.value)
        if chain is None:
            # informers[GVK].get(...) — subscripted receiver IS a cache
            base = _root_name(fn.value)
            return any(m in (base or "").lower() for m in _INFORMERISH)
        # Plural terminals (self.informers.get(gvk), caches.get(...)) are
        # containers OF informers — their .get returns an Informer object,
        # not a frozen view.
        term = chain[-1].lower()
        if term.endswith("s"):
            return False
        return any(m in part.lower() for part in chain for m in _INFORMERISH)

    def _scan_function(self, func, out: List[Tuple[int, str]]) -> None:
        tracked: set = set()

        def visit(stmts) -> None:
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # nested defs scanned by the outer walk
                if isinstance(st, ast.Assign):
                    self._flag_stores(st.targets, tracked, st.lineno, out)
                    self._rebind(st.targets, st.value, tracked)
                    self._flag_calls(st.value, tracked, out)
                elif isinstance(st, ast.AugAssign):
                    self._flag_stores([st.target], tracked, st.lineno, out)
                elif isinstance(st, ast.For):
                    if (isinstance(st.target, ast.Name)
                            and self._iter_tracked(st.iter, tracked)):
                        tracked.add(st.target.id)
                    self._flag_calls(st.iter, tracked, out)
                    visit(st.body)
                    visit(st.orelse)
                elif isinstance(st, (ast.If, ast.While)):
                    self._flag_calls(st.test, tracked, out)
                    visit(st.body)
                    visit(st.orelse)
                elif isinstance(st, ast.With):
                    visit(st.body)
                elif isinstance(st, ast.Try):
                    visit(st.body)
                    for h in st.handlers:
                        visit(h.body)
                    visit(st.orelse)
                    visit(st.finalbody)
                elif isinstance(st, ast.Expr):
                    self._flag_calls(st.value, tracked, out)
                elif isinstance(st, ast.Return) and st.value is not None:
                    self._flag_calls(st.value, tracked, out)
        visit(func.body)

    def _iter_tracked(self, it: ast.AST, tracked) -> bool:
        if isinstance(it, ast.Name) and it.id in tracked:
            return True
        return isinstance(it, ast.Call) and self._informerish(it)

    def _rebind(self, targets, value, tracked) -> None:
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            if isinstance(value, ast.Call) and self._informerish(value):
                tracked.add(t.id)
            elif isinstance(value, ast.Name) and value.id in tracked:
                tracked.add(t.id)
            else:
                tracked.discard(t.id)

    def _flag_stores(self, targets, tracked, lineno, out) -> None:
        # Subscript stores only: item assignment is what FrozenResource
        # forbids; attribute stores on tracked names are overwhelmingly
        # Informer-object configuration, not cache mutation.
        for t in targets:
            if isinstance(t, ast.Subscript):
                base = _root_name(t)
                if base in tracked:
                    out.append((
                        lineno,
                        f"assigns into '{base}', a frozen informer view; "
                        "thaw() it first (intent-to-write deep copy)"))

    def _flag_calls(self, expr: ast.AST, tracked, out) -> None:
        for node in ast.walk(expr):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS):
                base = _root_name(node.func.value)
                if base in tracked:
                    out.append((
                        node.lineno,
                        f"calls .{node.func.attr}() on '{base}', a frozen "
                        "informer view; thaw() it first"))


# The reference's accelerator stack, the port's (torch, triton), and the
# JAX package itself, which the port never imports.
_ACCELERATOR_ROOTS = {"jax", "jaxlib", "flax", "optax", "torch", "triton",
                      "kubeflow_tpu"}
_HEAVY_PREFIXES = (
    "kubeflow_tpu_torch.models", "kubeflow_tpu_torch.ops",
    "kubeflow_tpu_torch.train",
)


@register
class TorchFreeControlPlane(Rule):
    """R003: the control plane imports neither torch nor jax at module
    import time — a controller pod must start (and restart fast during
    chaos) without paying the accelerator stack's init, which stays on
    the workload side of the CRD boundary.  Function-local imports are
    the sanctioned escape for test-only or lazily-used paths."""

    id = "R003"
    summary = ("platform/controllers and platform/runtime must be "
               "import-time torch- and jax-free")
    scope = (CONTROLLERS, RUNTIME)

    def check(self, tree, text, path):
        for st in self._module_level(tree.body):
            mods: List[str] = []
            if isinstance(st, ast.Import):
                mods = [a.name for a in st.names]
            elif isinstance(st, ast.ImportFrom) and st.module:
                # `from kubeflow_tpu_torch import models` imports the
                # heavy submodule just as surely as `import
                # kubeflow_tpu_torch.models`
                # — check module+name joins, not just the module.
                mods = [st.module] + [f"{st.module}.{a.name}"
                                      for a in st.names]
            for mod in mods:
                root = mod.split(".")[0]
                if (root in _ACCELERATOR_ROOTS
                        or mod.startswith(_HEAVY_PREFIXES)):
                    yield (st.lineno,
                           f"module-level import of '{mod}' drags the "
                           "accelerator stack into control-plane import "
                           "time; import inside the function that needs it")

    def _module_level(self, body) -> Iterable[ast.stmt]:
        for st in body:
            yield st
            if isinstance(st, ast.If):       # TYPE_CHECKING / version gates
                yield from self._module_level(st.body)
                yield from self._module_level(st.orelse)
            elif isinstance(st, ast.Try):    # optional-dep probing
                yield from self._module_level(st.body)
                for h in st.handlers:
                    yield from self._module_level(h.body)


@register
class StatusViaPatch(Rule):
    """R004: status writes go through ``apply.patch_status_diff`` — a
    diff'd merge patch on the status subresource — never ``update_status``
    (a full-object status PUT).  A status-merge wipe is exactly a
    full status write racing a sibling field owner."""

    id = "R004"
    summary = "status writes use apply.patch_status_diff, never update_status"
    scope = (CONTROLLERS, RUNTIME)
    exclude = ("kubeflow_tpu_torch/platform/runtime/apply.py",)

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update_status"):
                yield (node.lineno,
                       "full-object update_status() can wipe sibling status "
                       "owners; use apply.patch_status_diff (merge patch of "
                       "the changed subtree)")


@register
class KnobRegistry(Rule):
    """R005: every environment knob resolves through the single-source
    registry in ``platform/config.py`` (``config.knob`` / ``config.env*``)
    so /debug/knobs can enumerate the live surface and docs stay honest.
    A stray ``os.environ`` literal is an undocumented, undumpable knob."""

    id = "R005"
    summary = "env knobs resolve through config.knob, not raw os.environ"
    scope = ("kubeflow_tpu_torch/*.py",)
    exclude = (
        "kubeflow_tpu_torch/platform/config.py",   # the registry itself
        "kubeflow_tpu_torch/analysis/*.py",
    )

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            # `from os import environ` aliases the mapping out from under
            # the receiver check — flag the import itself.
            if (isinstance(node, ast.ImportFrom) and node.module == "os"
                    and any(a.name in ("environ", "getenv")
                            for a in node.names)):
                yield (node.lineno,
                       "importing environ/getenv from os hides env reads "
                       "from the registry; import os and resolve through "
                       "config.knob")
            elif (isinstance(node, ast.Attribute) and node.attr == "environ"
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "os"):
                yield (node.lineno,
                       "raw os.environ read; resolve through config.knob("
                       "name, default, parser) so /debug/knobs sees it")
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "getenv"
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id == "os"):
                yield (node.lineno,
                       "raw os.getenv; resolve through config.knob(name, "
                       "default, parser) so /debug/knobs sees it")


_BROAD = {"Exception", "BaseException"}


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in _BROAD for e in t.elts)
    return False


@register
class NoSilentExcept(Rule):
    """R006: a broad ``except Exception: pass`` in control-plane code
    swallows the first symptom of every future bug.  The handler must at
    least debug-log with ``exc_info`` or bump a counter; where swallowing
    IS the contract (interpreter-shutdown ``__del__``), say so with an
    inline ``# kft: disable=R006 <reason>``."""

    id = "R006"
    summary = "no bare `except Exception: pass` without a log or counter"
    scope = (
        CONTROLLERS, RUNTIME,
        "kubeflow_tpu_torch/platform/webhook/*.py",
        "kubeflow_tpu_torch/platform/k8s/*.py",
        "kubeflow_tpu_torch/platform/native.py",
    )

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad_handler(node):
                continue
            if len(node.body) == 1 and isinstance(node.body[0], ast.Pass):
                yield (node.lineno,
                       "broad except swallows the error silently; "
                       "log.debug(..., exc_info=True), bump a counter, or "
                       "disable with a reason")


_METRIC_CTORS = {"Counter", "Gauge", "Histogram", "Summary"}
# Modules that own metric declarations: the two halves' metric surfaces
# plus the model server's own series.
_METRIC_MODULES = {
    "kubeflow_tpu_torch/platform/runtime/metrics.py",
    "kubeflow_tpu_torch/telemetry/metrics.py",
    "kubeflow_tpu_torch/telemetry/compute.py",
    "kubeflow_tpu_torch/telemetry/serve.py",
    "kubeflow_tpu_torch/models/serve.py",
}
# Bounded label keys.  Label VALUES must be bounded too (that part is a
# review judgment), but a label key outside this list is either a typo or
# a new cardinality decision that belongs in docs/observability.md first.
_LABEL_ALLOWLIST = {
    "controller", "result", "verb", "kind", "reason", "direction",
    "profile", "shard", "component", "queue", "name", "engine", "code",
    "method", "phase", "model", "app", "severity", "device", "le",
    "outcome", "pool", "action", "impl",
    # The fleet metrics pipeline (docs/observability.md "The metrics
    # pipeline"): "alert" is bounded by the declared SLO rule set,
    # "state" by the fixed alert/goodput state vocabularies.
    "alert", "state",
    # Continuous profiling (docs/observability.md "Profiling and
    # incidents"): "role" is bounded by the attribution seams —
    # controller/component names, registered pool names, and stripped
    # long-lived thread names; default Thread-N names all fold into the
    # single "unattributed" value.
    "role",
    # The serving front door (docs/serving.md "The front door"):
    # "tenant" is bounded by the profile set — the activator's
    # X-KFT-Tenant values are profile namespaces (plus "default"), the
    # same bounded vocabulary the quota ledger keys on.
    "tenant",
}


@register
class MetricHygiene(Rule):
    """R007: metric names are declared once, in a metrics module, with
    label keys from the bounded allowlist.  Duplicate names stack
    collectors on re-import (registry hygiene); ad-hoc
    label keys are where cardinality explosions start."""

    id = "R007"
    summary = ("metrics declared once in a metrics module; label keys "
               "from the bounded set")
    scope = ("kubeflow_tpu_torch/*.py",)

    def __init__(self):
        self._names: Dict[str, List[Tuple[str, int]]] = {}

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and _call_name(node) in _METRIC_CTORS):
                continue
            # Prometheus ctors take (name, documentation, ...): two leading
            # string literals — collections.Counter never looks like this.
            if not (len(node.args) >= 2
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                continue
            mname = node.args[0].value
            self._names.setdefault(mname, []).append((path, node.lineno))
            if path not in _METRIC_MODULES:
                yield (node.lineno,
                       f"metric '{mname}' declared outside a metrics "
                       "module; declare it in runtime/metrics.py or "
                       "telemetry/*")
            for label in self._labels(node):
                if label not in _LABEL_ALLOWLIST:
                    yield (node.lineno,
                           f"metric '{mname}' label key '{label}' is "
                           "outside the bounded allowlist "
                           "(analysis/rules.py _LABEL_ALLOWLIST); new keys "
                           "are a cardinality decision — add deliberately")

    def _labels(self, node: ast.Call) -> List[str]:
        cands = []
        if len(node.args) >= 3:
            cands.append(node.args[2])
        for kw in node.keywords:
            if kw.arg == "labelnames":
                cands.append(kw.value)
        out = []
        for c in cands:
            if isinstance(c, (ast.List, ast.Tuple)):
                for e in c.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value, str):
                        out.append(e.value)
        return out

    def finalize(self) -> List[Finding]:
        out = []
        for mname, sites in self._names.items():
            if len(sites) > 1:
                first = sites[0]
                for path, line in sites[1:]:
                    out.append(Finding(
                        self.id, path, line,
                        f"metric '{mname}' already declared at "
                        f"{first[0]}:{first[1]}; duplicate declarations "
                        "stack collectors on re-import"))
        return out


@register
class NoUnboundedBlocking(Rule):
    """R008: a reconcile body must never block without a bound —
    ``time.sleep`` (requeue with delay instead), ``.acquire()`` /
    ``.wait()`` / ``.join()`` with no timeout.  One stuck worker pins its
    key forever and eats a queue slot; the watchdog can dump it but not
    unstick it."""

    id = "R008"
    summary = ("no unbounded blocking (sleep, acquire/wait/join sans "
               "timeout) inside reconcile bodies")
    scope = (CONTROLLERS, RUNTIME)

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            name = node.name
            if not (name == "reconcile" or name.startswith("reconcile_")
                    or name.startswith("_reconcile")):
                continue
            yield from self._scan(node)

    def _scan(self, func) -> Iterable[Tuple[int, str]]:
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            chain = (_attr_chain(node.func)
                     if isinstance(node.func, ast.Attribute) else None)
            if chain == ["time", "sleep"]:
                yield (node.lineno,
                       "time.sleep in a reconcile body; return a requeue "
                       "delay instead (the workqueue owns time)")
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr not in ("acquire", "wait", "join"):
                continue
            has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
            if attr == "acquire":
                # acquire(False) / acquire(blocking=False) cannot block.
                nonblocking = (
                    (node.args
                     and isinstance(node.args[0], ast.Constant)
                     and node.args[0].value is False)
                    or any(kw.arg == "blocking"
                           and isinstance(kw.value, ast.Constant)
                           and kw.value.value is False
                           for kw in node.keywords)
                    or (len(node.args) >= 2))  # positional timeout
                if has_timeout or nonblocking:
                    continue
            else:
                if has_timeout or node.args:
                    continue
            yield (node.lineno,
                   f".{attr}() without a timeout inside a reconcile body "
                   "can block a worker forever; pass timeout= and handle "
                   "the miss")


@register
class StampedChildCreates(Rule):
    """R009: child-object creates in controllers go through the
    context-stamping ``runtime.apply`` helpers (``apply.create`` /
    ``create_or_update``) — a raw ``client.create`` drops the
    ``kubeflow.org/traceparent`` annotation and severs the object
    journey SILENTLY: the child converges fine, but its watch events,
    reconciles and write RTTs vanish from `/debug/journey` and the
    critical-path decomposition under-reports forever.  Scope: the
    INJECTED client only (``self.client`` / bare ``client``) — creates
    on any other client-shaped receiver are already R001 fence-bypass
    findings, and the two rules never double-report one site."""

    id = "R009"
    summary = ("controller child creates go through the context-stamping "
               "apply.create / create_or_update, never raw client.create")
    scope = (CONTROLLERS,)

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute) and fn.attr == "create"):
                continue
            chain = _attr_chain(fn.value)
            if chain in (["self", "client"], ["client"]):
                yield (node.lineno,
                       f"raw {'.'.join(chain)}.create() drops the "
                       "traceparent annotation and severs the child's "
                       "journey; use apply.create(self.client, obj) or "
                       "apply.create_or_update")


@register
class CodecSeamDecode(Rule):
    """R010: watch/list hot-path JSON decode routes through the
    ``k8s.codec`` seam (``decode_event`` / ``materialize``) — a raw
    ``json.loads`` in runtime/ or k8s/ re-opens the Python byte wall the
    native wire fast path removed: the event pays a full
    document parse again, invisibly to the codec engine counters and the
    ``ctrlplane_events_decoded_per_s`` band, and skips the LazyResource
    deferral that keeps non-admitted replicas from decoding bodies at
    all.  The seam modules themselves (codec.py, and client.py for raw
    error/Status bodies at the transport edge) are the sanctioned homes
    for the real parses."""

    id = "R010"
    summary = ("watch/list hot-path JSON decode goes through k8s.codec "
               "(decode_event/materialize), never raw json.loads")
    scope = (RUNTIME, "kubeflow_tpu_torch/platform/k8s/*.py")
    exclude = (
        "kubeflow_tpu_torch/platform/k8s/codec.py",   # the seam itself
        "kubeflow_tpu_torch/platform/k8s/client.py",  # transport edge
    )

    def check(self, tree, text, path):
        for node in ast.walk(tree):
            # `from json import loads` aliases the parser out from under
            # the receiver check — flag the import itself (R005 pattern).
            if (isinstance(node, ast.ImportFrom) and node.module == "json"
                    and any(a.name in ("loads", "load")
                            for a in node.names)):
                yield (node.lineno,
                       "importing loads/load from json hides hot-path "
                       "decodes from the codec seam; route through "
                       "codec.decode_event / codec.materialize")
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("loads", "load")
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id == "json"):
                yield (node.lineno,
                       "raw json." + node.func.attr + "() on the "
                       "watch/list hot path bypasses the codec seam; use "
                       "codec.decode_event / codec.materialize (native "
                       "fast path, engine counters, lazy bodies)")
