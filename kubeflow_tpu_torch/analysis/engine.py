"""kftlint engine: rule registry, suppressions, baseline, file driver.
The port's copy of ``kubeflow_tpu/analysis/engine.py``, whole; its
default walk is ``kubeflow_tpu_torch/``.

* A **Rule** owns an id (``R00x``), a one-line summary, and scope globs:
  the repo subtrees where its invariant holds.  ``check(tree, text,
  path)`` yields ``(lineno, message)`` findings for one file; rules that
  need cross-file state (duplicate metric names) override ``finalize()``.
  Rules are registered by class, so every run gets fresh instances.

* **Suppressions** are source comments, closest-wins:
  ``# kft: disable=R005 reason`` on the finding line (or on a standalone
  comment line directly above it) silences those rules for that line;
  ``# kft: disable-file=R003 reason`` anywhere in the file silences the
  whole file.  The reason is not parsed, but every suppression in the
  port carries one.

* The **baseline** is a checked-in JSON set of finding fingerprints:
  rule id + path + the *normalized source line* (plus a duplicate
  index), so unrelated edits above a baselined finding do not resurface
  it, while touching the offending line itself does.  The fingerprint is
  bit-equal to the reference's for the same rule, path and line.  A new
  rule lands green by baselining its existing findings and ratcheting
  to zero; the port's baseline, ``ci/kftlint_torch_baseline.json``, is
  empty.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_LINE_RE = re.compile(r"#\s*kft:\s*disable=([A-Za-z0-9_,]+)")
SUPPRESS_FILE_RE = re.compile(r"#\s*kft:\s*disable-file=([A-Za-z0-9_,]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, posix separators
    line: int          # 1-based
    message: str
    fingerprint: str = ""

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


class Rule:
    """One invariant.  Subclasses implement ``check``; ``scope``/``exclude``
    are fnmatch globs over repo-relative paths (fnmatch ``*`` crosses
    ``/``, so ``kubeflow_tpu_torch/platform/controllers/*.py`` covers
    the whole subtree)."""

    id: str = ""
    summary: str = ""
    scope: Sequence[str] = ()
    exclude: Sequence[str] = ()

    def applies(self, path: str) -> bool:
        if any(fnmatch.fnmatch(path, g) for g in self.exclude):
            return False
        return any(fnmatch.fnmatch(path, g) for g in self.scope)

    def check(self, tree: ast.AST, text: str, path: str) -> Iterable[Tuple[int, str]]:
        raise NotImplementedError

    def finalize(self) -> List[Finding]:
        return []


_REGISTRY: Dict[str, type] = {}


def register(rule_cls: type) -> type:
    """Class decorator adding a Rule subclass to the registry (keyed by id;
    a duplicate id is a programming error, not a merge surprise)."""
    rid = rule_cls.id
    if rid in _REGISTRY:
        raise ValueError(f"duplicate rule id {rid}")
    _REGISTRY[rid] = rule_cls
    return rule_cls


def all_rules() -> List[Rule]:
    """Fresh rule instances for one run (cross-file rules carry state)."""
    return [cls() for cls in _REGISTRY.values()]


# -- suppressions -------------------------------------------------------------


def _suppressions(text: str) -> Tuple[Set[str], Dict[int, Set[str]]]:
    """(file-wide suppressed rule ids, per-line suppressed rule ids).

    A standalone ``# kft: disable=...`` comment line suppresses the next
    line too, so long findings can carry the reason above them."""
    file_wide: Set[str] = set()
    by_line: Dict[int, Set[str]] = {}
    lines = text.splitlines()
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_FILE_RE.search(line)
        if m:
            file_wide |= set(m.group(1).split(","))
        m = SUPPRESS_LINE_RE.search(line)
        if m:
            rules = set(m.group(1).split(","))
            by_line.setdefault(i, set()).update(rules)
            if line.lstrip().startswith("#"):
                by_line.setdefault(i + 1, set()).update(rules)
    return file_wide, by_line


# -- fingerprints -------------------------------------------------------------


def _fingerprint(rule: str, path: str, norm_line: str, dup_index: int) -> str:
    h = hashlib.sha256(
        f"{rule}|{path}|{norm_line}|{dup_index}".encode()
    ).hexdigest()
    return h[:16]


def _attach_fingerprints(findings: List[Finding],
                         texts: Dict[str, str]) -> List[Finding]:
    seen: Dict[Tuple[str, str, str], int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        lines = texts.get(f.path, "").splitlines()
        norm = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
        key = (f.rule, f.path, norm)
        idx = seen.get(key, 0)
        seen[key] = idx + 1
        out.append(dataclasses.replace(
            f, fingerprint=_fingerprint(f.rule, f.path, norm, idx)))
    return out


# -- baseline -----------------------------------------------------------------


def load_baseline(path: str) -> Set[Tuple[str, str, str]]:
    if not os.path.exists(path):
        return set()
    with open(path) as fh:
        data = json.load(fh)
    return {(e["rule"], e["path"], e["fingerprint"])
            for e in data.get("findings", [])}


def write_baseline(findings: Sequence[Finding], path: str) -> None:
    data = {
        "version": 1,
        "findings": [
            {"rule": f.rule, "path": f.path, "fingerprint": f.fingerprint}
            for f in sorted(findings,
                            key=lambda f: (f.rule, f.path, f.fingerprint))
        ],
    }
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")


# -- driver -------------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", "node_modules"}


def _walk_default(root: str) -> List[str]:
    """Default lint set: every .py under kubeflow_tpu_torch/ (rule scopes
    narrow further)."""
    out = []
    base = os.path.join(root, "kubeflow_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        for fn in filenames:
            if fn.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(p.replace(os.sep, "/") for p in out)


def lint_source(text: str, path: str,
                rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Lint one in-memory file as if it lived at ``path`` (the corpus
    tests route bad/good twins through rule scopes this way).  Applies
    suppressions but not baselines; fingerprints are attached."""
    rules = list(rules) if rules is not None else all_rules()
    findings = _lint_one(text, path, rules)
    for r in rules:
        findings.extend(r.finalize())
    return _filter_suppressed(_attach_fingerprints(findings, {path: text}),
                              {path: text})


def _lint_one(text: str, path: str, rules: Sequence[Rule]) -> List[Finding]:
    applicable = [r for r in rules if r.applies(path)]
    if not applicable:
        return []
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("E000", path, e.lineno or 1,
                        f"syntax error: {e.msg}")]
    found = []
    for r in applicable:
        for line, msg in r.check(tree, text, path):
            found.append(Finding(r.id, path, line, msg))
    return found


def _filter_suppressed(findings: List[Finding],
                       texts: Dict[str, str]) -> List[Finding]:
    sup_cache: Dict[str, Tuple[Set[str], Dict[int, Set[str]]]] = {}
    out = []
    for f in findings:
        if f.path not in sup_cache:
            sup_cache[f.path] = _suppressions(texts.get(f.path, ""))
        file_wide, by_line = sup_cache[f.path]
        if f.rule in file_wide or f.rule in by_line.get(f.line, ()):
            continue
        out.append(f)
    return out


def lint_paths(paths: Optional[Sequence[str]] = None, *,
               root: str = ".") -> List[Finding]:
    """Lint ``paths`` (repo-relative; default: the kubeflow_tpu_torch
    tree under ``root``).  Returns unsuppressed findings with
    fingerprints attached; baseline subtraction is the caller's move
    (``load_baseline``)."""
    rels = list(paths) if paths else _walk_default(root)
    rules = all_rules()
    findings: List[Finding] = []
    texts: Dict[str, str] = {}
    for rel in rels:
        full = os.path.join(root, rel)
        try:
            with open(full, encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            continue
        texts[rel] = text
        findings.extend(_lint_one(text, rel, rules))
    for r in rules:
        findings.extend(r.finalize())
    return _filter_suppressed(_attach_fingerprints(findings, texts), texts)
