"""RFC 6902 JSON Patch: apply + diff.  The port's copy of
``kubeflow_tpu/platform/webhook/jsonpatch.py``, Python only: the
reference's native engine (``create_patch_fast``) is not ported, and
nothing here falls back to or from one.

The admission webhook responds to the API server with a JSONPatch computed
from (pod-before, pod-after) — same contract as the reference webhook
(reference admission-webhook/main.go:683-695 uses a patch library; this is
a native implementation).  ``create_patch`` emits minimal object-level ops;
arrays are replaced wholesale (the API server applies patches atomically, so
granularity only affects patch size, not semantics).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List


class PatchError(Exception):
    pass


def _unescape(token: str) -> str:
    return token.replace("~1", "/").replace("~0", "~")


def _escape(token: str) -> str:
    return token.replace("~", "~0").replace("/", "~1")


def _walk(doc: Any, pointer: str, *, create: bool = False):
    """Return (parent, last_token) for a JSON pointer."""
    if pointer == "":
        raise PatchError("empty pointer targets the root; handled by caller")
    if not pointer.startswith("/"):
        raise PatchError(f"invalid pointer {pointer!r}")
    tokens = [_unescape(t) for t in pointer.split("/")[1:]]
    cur = doc
    for tok in tokens[:-1]:
        if isinstance(cur, list):
            cur = cur[int(tok)]
        elif isinstance(cur, dict):
            if tok not in cur and create:
                cur[tok] = {}
            if tok not in cur:
                raise PatchError(f"path {pointer!r}: missing {tok!r}")
            cur = cur[tok]
        else:
            raise PatchError(f"path {pointer!r}: cannot traverse {type(cur).__name__}")
    return cur, tokens[-1]


def apply_patch(doc: Any, ops: List[Dict[str, Any]]) -> Any:
    """Apply RFC 6902 ops to a deep copy of ``doc`` and return it."""
    doc = copy.deepcopy(doc)
    for op in ops:
        kind = op.get("op")
        path = op.get("path", "")
        if kind in ("add", "replace") and path == "":
            doc = copy.deepcopy(op["value"])
            continue
        parent, last = _walk(doc, path, create=(kind == "add"))
        if kind == "add":
            if isinstance(parent, list):
                if last == "-":
                    parent.append(copy.deepcopy(op["value"]))
                else:
                    parent.insert(int(last), copy.deepcopy(op["value"]))
            else:
                parent[last] = copy.deepcopy(op["value"])
        elif kind == "replace":
            if isinstance(parent, list):
                parent[int(last)] = copy.deepcopy(op["value"])
            else:
                if last not in parent:
                    raise PatchError(f"replace at missing path {path!r}")
                parent[last] = copy.deepcopy(op["value"])
        elif kind == "remove":
            if isinstance(parent, list):
                del parent[int(last)]
            else:
                if last not in parent:
                    raise PatchError(f"remove at missing path {path!r}")
                del parent[last]
        elif kind == "test":
            current = parent[int(last)] if isinstance(parent, list) else parent.get(last)
            if current != op.get("value"):
                raise PatchError(f"test failed at {path!r}")
        elif kind in ("move", "copy"):
            src_parent, src_last = _walk(doc, op["from"])
            val = (
                src_parent[int(src_last)]
                if isinstance(src_parent, list)
                else src_parent[src_last]
            )
            if kind == "move":
                if isinstance(src_parent, list):
                    del src_parent[int(src_last)]
                else:
                    del src_parent[src_last]
            apply_patch_inplace_add(doc, path, copy.deepcopy(val))
        else:
            raise PatchError(f"unknown op {kind!r}")
    return doc


def apply_patch_inplace_add(doc: Any, path: str, value: Any) -> None:
    parent, last = _walk(doc, path, create=True)
    if isinstance(parent, list):
        if last == "-":
            parent.append(value)
        else:
            parent.insert(int(last), value)
    else:
        parent[last] = value


def create_patch(before: Any, after: Any, path: str = "") -> List[Dict[str, Any]]:
    """Minimal-ish diff: recurse into dicts, replace scalars/arrays."""
    if type(before) is not type(after):
        return [{"op": "replace", "path": path or "", "value": after}]
    if isinstance(before, dict):
        ops: List[Dict[str, Any]] = []
        for key in before:
            sub = f"{path}/{_escape(key)}"
            if key not in after:
                ops.append({"op": "remove", "path": sub})
            elif before[key] != after[key]:
                ops.extend(create_patch(before[key], after[key], sub))
        for key in after:
            if key not in before:
                ops.append(
                    {"op": "add", "path": f"{path}/{_escape(key)}", "value": after[key]}
                )
        return ops
    if before != after:
        return [{"op": "replace", "path": path or "", "value": after}]
    return []
