"""A tiny counter / gauge / histogram registry rendered in the Prometheus
text exposition format (version 0.0.4).  Standard library only: the
serving path must run where ``prometheus_client`` is not installed.

Each instrument may carry label names; ``labels(**values)`` returns the
child for one label set.  All methods are thread-safe.  A
``ScrapeGauge`` is a scrape-time collector: its samples are computed
when the registry renders.  The histogram quantile helpers
(``histogram_snapshot``, ``quantile_from_buckets``,
``histogram_quantiles``) are the port's copy of
``kubeflow_tpu/telemetry/metrics.py``'s, over this module's histograms.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return f"{v:.1f}"
    return repr(float(v))


def _labels(names: Sequence[str], values: Tuple[str, ...],
            extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(zip(names, values))
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    esc = lambda v: (v.replace("\\", "\\\\").replace("\n", "\\n")
                     .replace('"', '\\"'))
    body = ",".join(f'{k}="{esc(v)}"' for k, v in pairs)
    return "{" + body + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, doc: str, labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def labels(self, **values):
        key = tuple(str(values[n]) for n in self.labelnames)
        with self._lock:
            if key not in self._children:
                self._children[key] = self._new_child()
            return self._children[key]

    def sample(self, **values) -> Optional[float]:
        """The value of a counter's or gauge's child for one label set;
        None when that label set was never used."""
        key = tuple(str(values[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
        return None if child is None else child.value

    def values(self) -> Dict[Tuple[str, ...], float]:
        """A counter's or gauge's value for every label set used so far,
        keyed by the label values in ``labelnames`` order."""
        with self._lock:
            children = list(self._children.items())
        return {key: child.value for key, child in children}

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels; use .labels()")
        return self._children[()]

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.doc}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:
            lines.extend(child.samples(self.name, self.labelnames, key))
        return lines


class _Value:
    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def samples(self, name, names, key):
        return [f"{name}{_labels(names, key)} {_fmt(self.value)}"]


class _CounterValue(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        super().inc(amount)


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterValue()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _Value()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)


class _Buckets:
    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self.counts[i] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper bound, observations at or below it) for every bucket."""
        with self._lock:
            return list(zip(self.bounds, self.counts))

    def samples(self, name, names, key):
        with self._lock:
            out = [f"{name}_bucket{_labels(names, key, ('le', _fmt(b)))} {c}"
                   for b, c in zip(self.bounds, self.counts)]
            out.append(f"{name}_count{_labels(names, key)} {self.count}")
            out.append(f"{name}_sum{_labels(names, key)} {_fmt(self.sum)}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None, *,
                 buckets: Sequence[float] = (0.01, 0.1, 1.0, 10.0)):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != math.inf:
            bounds = bounds + (math.inf,)
        self._bounds = bounds
        super().__init__(name, doc, labelnames, registry)

    def _new_child(self):
        return _Buckets(self._bounds)

    def observe(self, v: float) -> None:
        self._only().observe(v)


class ScrapeGauge:
    """A gauge family whose samples ``collect()`` computes each time the
    registry renders (the reference's custom collectors): ``collect``
    returns ``[(label values, value), ...]``, an empty list for a family
    with no samples."""

    kind = "gauge"

    def __init__(self, name: str, doc: str,
                 collect: Callable[[], Iterable[Tuple[Sequence[str], float]]],
                 labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._collect = collect
        if registry is not None:
            registry.register(self)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.doc}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, value in self._collect():
            lines.append(f"{self.name}{_labels(self.labelnames, tuple(key))}"
                         f" {_fmt(value)}")
        return lines


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: List[_Metric] = []

    def register(self, metric) -> None:
        """Add a metric or a ``ScrapeGauge`` (anything with a unique
        ``name`` and ``render()``)."""
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics.append(metric)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


def histogram_snapshot(hist: Histogram,
                       match: Dict[str, str]) -> Dict[float, float]:
    """Cumulative bucket counts by upper bound, summed over the children
    of ``hist`` whose labels include ``match`` (over ``phase`` for the
    train-step histogram when ``match`` is empty)."""
    with hist._lock:
        children = list(hist._children.items())
    buckets: Dict[float, float] = {}
    for key, child in children:
        labels = dict(zip(hist.labelnames, key))
        if not all(labels.get(k) == v for k, v in match.items()):
            continue
        for le, count in child.cumulative():
            buckets[le] = buckets.get(le, 0.0) + count
    return buckets


def quantile_from_buckets(buckets: Dict[float, float],
                          q: float) -> Optional[float]:
    """Prometheus-style linear interpolation within the target bucket.
    None on an empty histogram; the +Inf bucket clamps to the highest
    finite bound (as ``histogram_quantile`` does)."""
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_count = 0.0, 0.0
    finite = [b for b in bounds if b != math.inf]
    for b in bounds:
        count = buckets[b]
        if count >= rank:
            if b == math.inf:
                return finite[-1] if finite else None
            if count == prev_count:
                return b
            return prev_bound + (b - prev_bound) * (
                (rank - prev_count) / (count - prev_count))
        prev_bound, prev_count = (0.0 if b == math.inf else b), count
    return finite[-1] if finite else None


def histogram_quantiles(hist: Histogram, match: Dict[str, str],
                        qs=(0.5, 0.99), *,
                        since: Optional[Dict[float, float]] = None
                        ) -> Dict[float, Optional[float]]:
    """Estimated quantiles of one histogram slice; ``since`` (an earlier
    ``histogram_snapshot``) diffs out the observations made before it."""
    buckets = histogram_snapshot(hist, match)
    if since is not None:
        buckets = {le: c - since.get(le, 0.0) for le, c in buckets.items()}
    return {q: quantile_from_buckets(buckets, q) for q in qs}
