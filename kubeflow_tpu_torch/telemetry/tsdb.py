"""A bounded in-process time-series store — the storage layer of the
fleet metrics pipeline.  The port's copy of
``kubeflow_tpu/telemetry/tsdb.py``, whole; a page is read by the port's
``telemetry/metrics.parse_text`` where the reference reads it with
``prometheus_client.parser``.

Everything upstream of this module *emits* telemetry point-in-time
(Prometheus registries, scraped /metrics pages); everything downstream
*decides* from history (burn-rate SLO alerts, the InferenceService
autoscaler's TTFT deltas, goodput integration).  The TSDB is the seam:
append-only samples into fixed-capacity ring buffers per
``(name, labels)`` series, plus a small PURE query surface —

* ``instant``/``values_at``/``window`` — point and range lookups;
* ``increase``/``rate`` — counter math, **reset-aware** (a replica
  restart drops a counter to ~0; the pre-reset head must neither be
  lost nor read as a negative rate);
* ``histogram_quantile`` — Prometheus-style quantile estimation over
  stored ``*_bucket`` series (grouped by labels sans ``le``, merged,
  interpolated through the shared ``quantile_from_buckets``), either at
  an instant or over a windowed increase;
* ``merged_at`` — the exact-timestamp bucket merge the InferenceService
  autoscaler's pass-delta path is built on.

Bounds (both knobless constructor parameters — the OWNING layer sizes
them, see fleetscrape): ``capacity`` samples per series (ring — old
samples fall off), ``max_series`` series total (exceeding it evicts the
series with the OLDEST last sample first: a target that stopped
reporting is the stale one, not the hot series that just appended).
Thread-safe; no platform imports — the telemetry core stays dependency-
free so both planes (and tests) can hold one without a control plane.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from kubeflow_tpu_torch.telemetry.metrics import parse_text, quantile_from_buckets

DEFAULT_CAPACITY = 360          # ~1.5h at a 15 s cadence
DEFAULT_MAX_SERIES = 8192

LabelItems = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Optional[Dict[str, str]]) -> LabelItems:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _matches(labelkey: LabelItems, matcher: Optional[Dict[str, str]]) -> bool:
    if not matcher:
        return True
    have = dict(labelkey)
    return all(have.get(k) == str(v) for k, v in matcher.items())


class _Series:
    __slots__ = ("name", "labelkey", "samples", "last_ts")

    def __init__(self, name: str, labelkey: LabelItems, capacity: int):
        self.name = name
        self.labelkey = labelkey
        self.samples: deque = deque(maxlen=capacity)  # (ts, value)
        self.last_ts = -math.inf


class TSDB:
    """The store.  All public methods are thread-safe."""

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.capacity = max(2, int(capacity))
        self.max_series = max(1, int(max_series))
        self.evictions = 0           # series evicted at the max_series bound
        self.appends = 0             # samples ever appended (bench counter)
        self._lock = threading.Lock()
        # (name, labelkey) -> _Series, plus a name index so every query
        # touches only same-name series — rule evaluation must stay
        # O(matching series), never O(store) (the bench band's tripwire).
        self._series: Dict[Tuple[str, LabelItems], _Series] = {}
        self._by_name: Dict[str, Dict[LabelItems, _Series]] = {}

    # -- writes ---------------------------------------------------------------

    def append(self, name: str, labels: Optional[Dict[str, str]] = None,
               value: float = 0.0, ts: Optional[float] = None) -> None:
        """Append one sample.  ``ts`` defaults to nothing deliberately —
        the scrape layer stamps ONE timestamp per pass so a pass's
        samples are exact-ts joinable (``values_at``/``merged_at``)."""
        if ts is None:
            import time

            ts = time.time()
        key = (name, _labelkey(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    self._evict_locked()
                series = _Series(name, key[1], self.capacity)
                self._series[key] = series
                self._by_name.setdefault(name, {})[key[1]] = series
            series.samples.append((float(ts), float(value)))
            if ts > series.last_ts:
                series.last_ts = float(ts)
            self.appends += 1

    def _evict_locked(self) -> None:
        """Evict the series whose LAST sample is oldest — the stale
        series a dead target left behind, never the one still appending
        (pinned by test_tsdb.py::test_stale_series_evicted_at_capacity)."""
        victim = min(self._series, key=lambda k: self._series[k].last_ts)
        self._del_locked(victim)
        self.evictions += 1

    def _del_locked(self, key: Tuple[str, LabelItems]) -> None:
        del self._series[key]
        bucket = self._by_name.get(key[0])
        if bucket is not None:
            bucket.pop(key[1], None)
            if not bucket:
                del self._by_name[key[0]]

    def drop(self, name: Optional[str] = None,
             matcher: Optional[Dict[str, str]] = None) -> int:
        """Delete matching series (a deleted service's scrape memory);
        returns the count dropped."""
        with self._lock:
            gone = [k for k, s in self._series.items()
                    if (name is None or s.name == name)
                    and _matches(s.labelkey, matcher)]
            for k in gone:
                self._del_locked(k)
            return len(gone)

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def names(self) -> List[str]:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    def labelsets(self, name: str,
                  matcher: Optional[Dict[str, str]] = None
                  ) -> List[Dict[str, str]]:
        return [dict(lk) for lk, _ in self._select(name, matcher)]

    def _select(self, name: str, matcher: Optional[Dict[str, str]]
                ) -> List[Tuple[LabelItems, List[Tuple[float, float]]]]:
        with self._lock:
            return [(lk, list(s.samples))
                    for lk, s in self._by_name.get(name, {}).items()
                    if _matches(lk, matcher)]

    # -- reads ----------------------------------------------------------------

    def instant(self, name: str, matcher: Optional[Dict[str, str]] = None,
                at: Optional[float] = None,
                staleness: Optional[float] = None
                ) -> List[Tuple[Dict[str, str], float, float]]:
        """Latest sample at or before ``at`` per matching series, as
        ``(labels, ts, value)``.  ``staleness`` drops series whose latest
        sample is older than ``at - staleness`` (a dead scrape target's
        frozen last value must not read as live — the goodput
        no-double-count contract)."""
        out = []
        for lk, samples in self._select(name, matcher):
            picked = None
            for ts, v in reversed(samples):
                if at is None or ts <= at:
                    picked = (ts, v)
                    break
            if picked is None:
                continue
            if (staleness is not None and at is not None
                    and picked[0] < at - staleness):
                continue
            out.append((dict(lk), picked[0], picked[1]))
        return out

    def values_at(self, name: str, matcher: Optional[Dict[str, str]] = None,
                  ts: float = 0.0, eps: float = 1e-9
                  ) -> List[Tuple[Dict[str, str], float]]:
        """Samples at EXACTLY ``ts`` (± eps) — the scrape-pass join: one
        pass stamps one timestamp, so a series that missed the pass is
        absent rather than contributing its stale last value."""
        out = []
        for lk, samples in self._select(name, matcher):
            for sts, v in reversed(samples):
                if abs(sts - ts) <= eps:
                    out.append((dict(lk), v))
                    break
                if sts < ts - eps:
                    break
        return out

    def window(self, name: str, matcher: Optional[Dict[str, str]] = None,
               start: float = -math.inf, end: float = math.inf
               ) -> List[Tuple[Dict[str, str], List[Tuple[float, float]]]]:
        """Range lookup: every matching series' samples in [start, end]."""
        return [(dict(lk), [(ts, v) for ts, v in samples
                            if start <= ts <= end])
                for lk, samples in self._select(name, matcher)]

    def latest_n(self, name: str, matcher: Optional[Dict[str, str]] = None,
                 n: int = 2) -> List[Tuple[float, float]]:
        """Newest ``n`` samples (ts, value) across matching series,
        newest first — the autoscaler reads its scrape-pass records
        (this pass + the previous) through this."""
        merged: List[Tuple[float, float]] = []
        for _lk, samples in self._select(name, matcher):
            merged.extend(samples)
        merged.sort(key=lambda s: s[0], reverse=True)
        return merged[:n]

    # -- counter math ---------------------------------------------------------

    @staticmethod
    def _increase_of(samples: List[Tuple[float, float]]) -> float:
        """Reset-aware increase across consecutive samples: a drop means
        the counter restarted (replica restart) — the post-reset value IS
        the increase since the reset, and the pre-reset head is already
        accumulated.  Matches Prometheus ``increase`` up to its
        extrapolation (deliberately none here: scrape cadences are
        coarse and decisions prefer under- to over-counting)."""
        inc = 0.0
        prev = None
        for _ts, v in samples:
            if prev is not None:
                inc += v if v < prev else v - prev
            prev = v
        return inc

    @classmethod
    def _series_increase(cls, samples: List[Tuple[float, float]],
                         start: float, at: float) -> float:
        """One series' reset-aware increase over [start, at].  A series'
        first sample inside the window anchors against the last sample
        BEFORE the window when one exists (a window never misses the
        increase that landed exactly on its edge).  A series with no
        prior sample contributes only deltas BETWEEN its in-window
        samples — Prometheus semantics: a single cumulative observation
        is history, not an increase.  (Counting a first-ever sample at
        its full value would read a long-lived remote counter's whole
        lifetime as in-window events on the first scrape after a
        restart — a spurious burn-rate page on a healthy fleet.)"""
        inside = [(ts, v) for ts, v in samples if start <= ts <= at]
        if not inside:
            return 0.0
        before = [(ts, v) for ts, v in samples if ts < start]
        if before:
            inside = [before[-1]] + inside
        return cls._increase_of(inside)

    def increase(self, name: str, matcher: Optional[Dict[str, str]] = None,
                 window: float = math.inf, at: Optional[float] = None
                 ) -> float:
        """Summed reset-aware increase over the window ending at ``at``
        for every matching counter series (see ``_series_increase`` for
        the edge semantics)."""
        if at is None:
            import time

            at = time.time()
        start = at - window
        return sum(self._series_increase(samples, start, at)
                   for _lk, samples in self._select(name, matcher))

    def rate(self, name: str, matcher: Optional[Dict[str, str]] = None,
             window: float = 300.0, at: Optional[float] = None) -> float:
        """increase / window — per-second counter rate."""
        if window <= 0:
            return 0.0
        return self.increase(name, matcher, window=window, at=at) / window

    # -- histograms -----------------------------------------------------------

    def merged_at(self, bucket_name: str,
                  matcher: Optional[Dict[str, str]] = None,
                  ts: Optional[float] = None, *, exact: bool = True
                  ) -> Dict[float, float]:
        """Cumulative buckets ``{le: value}`` merged (summed) over every
        matching series at one timestamp.  ``exact=True`` joins on the
        scrape-pass timestamp (``values_at`` semantics: a series absent
        from that pass contributes nothing); ``exact=False`` takes each
        series' latest sample at or before ``ts``."""
        buckets: Dict[float, float] = {}
        if exact and ts is not None:
            rows = [(labels, v)
                    for labels, v in self.values_at(bucket_name, matcher, ts)]
        else:
            rows = [(labels, v)
                    for labels, _sts, v in self.instant(bucket_name, matcher,
                                                        at=ts)]
        for labels, v in rows:
            le = labels.get("le")
            if le is None:
                continue
            try:
                bound = float(le)
            except ValueError:
                continue
            buckets[bound] = buckets.get(bound, 0.0) + v
        return buckets

    def bucket_increases(self, bucket_name: str,
                         matcher: Optional[Dict[str, str]] = None,
                         window: float = math.inf,
                         at: Optional[float] = None) -> Dict[float, float]:
        """Windowed reset-aware increase per ``le`` bound, merged over
        matching series — the burn-rate engine's good/total source.  ONE
        pass over the matching series (each series carries exactly one
        ``le``), never a rescan per bound."""
        if at is None:
            import time

            at = time.time()
        start = at - window
        out: Dict[float, float] = {}
        for lk, samples in self._select(bucket_name, matcher):
            le = dict(lk).get("le")
            if le is None:
                continue
            try:
                bound = float(le)
            except ValueError:
                continue
            out[bound] = (out.get(bound, 0.0)
                          + self._series_increase(samples, start, at))
        return out

    def histogram_quantile(self, q: float, bucket_name: str,
                           matcher: Optional[Dict[str, str]] = None, *,
                           window: Optional[float] = None,
                           at: Optional[float] = None) -> Optional[float]:
        """Prometheus-style quantile over stored bucket series: with
        ``window``, over the reset-aware windowed increase (what a
        recording rule wants); without, over the cumulative merge at
        ``at`` (whole-history quantile).  None on empty/sparse-empty
        buckets, same as ``quantile_from_buckets``."""
        if window is not None:
            buckets = self.bucket_increases(bucket_name, matcher,
                                            window=window, at=at)
        else:
            buckets = self.merged_at(bucket_name, matcher, ts=at, exact=False)
        # Sparse series can yield empty or all-zero merges; the shared
        # interpolator returns None for both.
        return quantile_from_buckets(buckets, q)

    # -- text ingestion -------------------------------------------------------

    def ingest_page(self, text: str,
                    labels: Optional[Dict[str, str]] = None,
                    ts: Optional[float] = None,
                    names: Optional[Iterable[str]] = None) -> int:
        """Parse one Prometheus exposition page and append every sample
        (bucket/sum/count expansions included) with ``labels`` merged
        over the sample's own.  Returns the sample count; raises
        ``ValueError`` on an unparseable page (the scrape layer counts
        it as reason="parse")."""
        if ts is None:
            import time

            ts = time.time()
        wanted = set(names) if names is not None else None
        n = 0
        # The parser raises on malformed lines lazily; materialize inside
        # the try so a torn page is one clean ValueError for the caller.
        try:
            samples = list(parse_text(text))
        except ValueError as e:
            raise ValueError(f"unparseable metrics page: {e}") from e
        for sname, slabels, value in samples:
            if wanted is not None and sname not in wanted:
                continue
            merged = dict(slabels)
            if labels:
                merged.update(labels)
            self.append(sname, merged, value, ts=ts)
            n += 1
        return n
