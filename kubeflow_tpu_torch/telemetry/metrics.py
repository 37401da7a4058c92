"""A tiny counter / gauge / histogram registry rendered in the Prometheus
text exposition format (version 0.0.4).  Standard library only: the
serving path must run where ``prometheus_client`` is not installed.

Each instrument may carry label names; ``labels(**values)`` returns the
child for one label set.  All methods are thread-safe.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


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


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: List[_Metric] = []

    def register(self, metric: _Metric) -> None:
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
