"""Critical-path decomposition of an object journey: the port's copy of
``kubeflow_tpu/telemetry/critical_path.py``.

Input: the span list of one causal journey (``telemetry/causal.py``,
one trace id's spans, possibly merged across replicas).  Output: the
longest causal chain through the journey and its decomposition into
the named segments an operator can act on:

========================  ====================================================
segment                   what the time is
========================  ====================================================
``watch_lag``             API write committed → watch event delivered to the
                          controller (stamp wall time → delivery wall time)
``queue_wait``            watch delivery → workqueue dequeue
``reconcile``             reconcile body wall time (minus carved-out children)
``write_rtt``             one child write's round trip inside a reconcile
``admission_queue``       the GPUJob queue's decision wait (queuedAt →
                          admitted)
``readiness_warm``        controller-side /readyz warm-probe round trip
``pod_start``             a gap on the path right after pod-owning child
                          writes: kubelet territory (image pull, start)
``unattributed``          any other gap on the path (idle between causes)
========================  ====================================================

The chain is rebuilt backwards from the journey's last-ending span: each
step picks the latest-ending span that finished before the current one
began (causes strictly precede effects on one timeline; the API server
serializes reconcile-driven causality).  Path spans are then expanded: a
reconcile span containing write_rtt / admission_queue / readiness_warm
child spans is split around them, so the decomposition separates
reconcile CPU from the I/O it paid.  Gaps between path spans are
attributed (pod_start / a covering admission_queue wait / unattributed)
rather than dropped, so the segments sum to the journey's end-to-end
wall time by construction.
"""
from __future__ import annotations

from typing import Dict, List, Optional

EPS = 1e-4          # causal-ordering tolerance (may A precede B?)
TILE_EPS = 1e-9     # tiling tolerance: every positive gap becomes an entry

SEGMENTS = ("watch_lag", "queue_wait", "reconcile", "write_rtt",
            "pod_start", "admission_queue", "readiness_warm")

# Segments that may be carved out of a containing path span (they happen
# INSIDE a reconcile); watch_lag/queue_wait spans of unrelated objects
# merely OVERLAP a reconcile window on the wall clock and must not be
# spliced into it.
_NESTABLE = frozenset({"write_rtt", "admission_queue", "readiness_warm"})

# Child kinds whose creation hands off to the kubelet: a path gap right
# after writing one of these is container start time, not controller
# idleness.
POD_OWNER_KINDS = frozenset({"StatefulSet", "Deployment", "Pod"})


def critical_path(spans: List[dict]) -> List[dict]:
    """The longest causal chain, earliest-first: walk back from the
    last-ending span, each time to the latest-ending span that completed
    before the current one started."""
    spans = [s for s in spans
             if s.get("end_ts") is not None and s.get("start_ts") is not None]
    if not spans:
        return []
    cur = max(spans, key=lambda s: s["end_ts"])
    path = [cur]
    # Visited guard: EPS-tolerant ordering lets two spans within EPS of
    # each other read as MUTUAL predecessors (adjacent sub-100µs writes),
    # and without the guard the walk would alternate between them
    # forever.  Each step must add a new span, so the walk is bounded by
    # the journey size.
    visited = {id(cur)}
    while True:
        preds = [s for s in spans
                 if id(s) not in visited
                 and s["end_ts"] <= cur["start_ts"] + EPS]
        if not preds:
            break
        cur = max(preds, key=lambda s: (s["end_ts"], s["start_ts"]))
        visited.add(id(cur))
        path.append(cur)
    path.reverse()
    return path


def _slice(span: dict, start: float, end: float) -> dict:
    out = dict(span)
    out["start_ts"], out["end_ts"] = start, end
    out["duration_ms"] = round(max(end - start, 0.0) * 1e3, 3)
    return out


def _expand_one(sp: dict, spans: List[dict]) -> List[dict]:
    """Split a path span around the nestable child spans it contains.
    Tail containment is enough (an admission_queue wait may START before
    the reconcile that resolves it): the child's contribution is clipped
    to the container's window."""
    inner = [s for s in spans
             if s is not sp and s.get("segment") in _NESTABLE
             and sp["start_ts"] + EPS < s["end_ts"] <= sp["end_ts"] + EPS]
    if not inner:
        return [dict(sp)]
    inner.sort(key=lambda s: (max(s["start_ts"], sp["start_ts"]),
                              s["end_ts"]))
    out: List[dict] = []
    cursor = sp["start_ts"]
    for s in inner:
        a = max(s["start_ts"], sp["start_ts"], cursor)
        if s["end_ts"] < cursor - TILE_EPS:
            continue  # fully swallowed by an earlier sibling carve-out
        if a > cursor + TILE_EPS:
            out.append(_slice(sp, cursor, a))
        out.append(_slice(s, a, max(s["end_ts"], a)))
        cursor = max(cursor, s["end_ts"])
    if sp["end_ts"] > cursor + TILE_EPS:
        out.append(_slice(sp, cursor, sp["end_ts"]))
    return out


def _wrote_pod_owner(span: dict, spans: List[dict]) -> bool:
    if (span.get("segment") == "write_rtt"
            and span.get("kind") in POD_OWNER_KINDS):
        return True
    return any(s.get("segment") == "write_rtt"
               and s.get("kind") in POD_OWNER_KINDS
               and span["start_ts"] - EPS <= s["end_ts"]
               <= span["end_ts"] + EPS
               for s in spans)


def _gap_segment(prev: Optional[dict], spans: List[dict],
                 gap_start: float, gap_end: float) -> str:
    # A recorded wait span covering the whole gap names it (a Queued
    # GPUJob's poll-to-poll idle time IS admission-queue wait).
    # TILE_EPS, not EPS: with the looser tolerance a ZERO-LENGTH
    # admission span "covered" any sub-EPS gap adjacent to it and the
    # decomposition double-counted the admission segment.
    for s in spans:
        if (s.get("segment") in ("admission_queue", "pod_start")
                and s["start_ts"] <= gap_start + TILE_EPS
                and s["end_ts"] >= gap_end - TILE_EPS):
            return s["segment"]
    if prev is not None and _wrote_pod_owner(prev, spans):
        return "pod_start"
    return "unattributed"


def _merge_contiguous(entries: List[dict]) -> List[dict]:
    """Fold adjacent same-segment path entries into one: a genuinely
    queued admission produces BOTH an attributed gap (the poll-to-poll
    wait) and the span's tail carved into the granting reconcile — the
    same wait, and the 'exactly one admission_queue segment' contract
    counts it once.  Distinct waits (a re-queue after preemption)
    remain separate because other segments sit between them.  Prefers
    the real span's name/attrs over a gap's."""
    out: List[dict] = []
    for e in entries:
        prev = out[-1] if out else None
        if (prev is not None
                and (prev.get("segment") or "unattributed")
                == (e.get("segment") or "unattributed")
                and e["start_ts"] <= prev["end_ts"] + TILE_EPS):
            merged = dict(e if prev["name"] == "gap" else prev)
            merged["start_ts"] = prev["start_ts"]
            merged["end_ts"] = max(prev["end_ts"], e["end_ts"])
            merged["duration_ms"] = round(
                (merged["end_ts"] - merged["start_ts"]) * 1e3, 3)
            out[-1] = merged
        else:
            out.append(e)
    return out


def decompose(spans: List[dict]) -> dict:
    """Critical path + segment decomposition of one journey.  Returns
    ``{"total_s", "segments": {name: seconds}, "path": [entries]}`` where
    the path entries (expanded spans + attributed gaps) tile
    ``[first_start, last_end]`` exactly, so
    ``sum(segments.values()) == total_s``."""
    path = critical_path(spans)
    if not path:
        return {"total_s": 0.0, "segments": {}, "path": []}
    entries: List[dict] = []
    prev_end: Optional[float] = None
    prev_span: Optional[dict] = None
    for sp in path:
        if prev_end is not None and sp["start_ts"] > prev_end + TILE_EPS:
            seg = _gap_segment(prev_span, spans, prev_end, sp["start_ts"])
            entries.append({
                "name": "gap", "segment": seg,
                "start_ts": prev_end, "end_ts": sp["start_ts"],
                "duration_ms": round(
                    (sp["start_ts"] - prev_end) * 1e3, 3),
            })
        entries.extend(_expand_one(sp, spans))
        prev_end = sp["end_ts"] if prev_end is None \
            else max(prev_end, sp["end_ts"])
        prev_span = sp
    entries = _merge_contiguous(entries)
    segments: Dict[str, float] = {}
    for e in entries:
        seg = e.get("segment") or "unattributed"
        segments[seg] = segments.get(seg, 0.0) + max(
            e["end_ts"] - e["start_ts"], 0.0)
    total = path[-1]["end_ts"] - path[0]["start_ts"]
    return {
        "total_s": round(total, 6),
        "segments": {k: round(v, 6) for k, v in sorted(segments.items())},
        "path": entries,
    }


def segment_summary(spans: List[dict]) -> Dict[str, float]:
    """decompose()'s segments rounded for a JSON metric line (empty
    dict on an empty journey)."""
    return {k: round(v, 4)
            for k, v in decompose(spans)["segments"].items()}
