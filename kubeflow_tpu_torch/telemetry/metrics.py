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
``parse_text`` reads an exposition page back into samples, where the
reference reads it with ``prometheus_client.parser``.
"""
from __future__ import annotations

import math
import re
import threading
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)


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


# -- reading a page back ------------------------------------------------------

_METRIC_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_UNESCAPE = re.compile(r'\\[\\n"]')
_UNESCAPED = {"\\\\": "\\", "\\n": "\n", '\\"': '"'}

Sample = Tuple[str, Dict[str, str], float]


def _escaped(s: str, at: int) -> bool:
    """Whether the character at ``at`` follows an odd run of
    backslashes."""
    n = 0
    while at - 1 - n >= 0 and s[at - 1 - n] == "\\":
        n += 1
    return n % 2 == 1


def _find_unquoted(s: str, chars: str, start: int = 0) -> int:
    """The first index at or after ``start`` of one of ``chars`` outside
    a double-quoted string, or -1."""
    quoted = False
    for i in range(start, len(s)):
        c = s[i]
        if c == '"' and not _escaped(s, i):
            quoted = not quoted
        if not quoted and c in chars:
            return i
    return -1


def _closing_quote(s: str) -> int:
    """The index of the first unescaped ``"`` after ``s[0]``."""
    at = 1
    while at < len(s):
        at = s.index('"', at)  # ValueError: never closed
        if not _escaped(s, at):
            break
        at += 1
    return at


def _unquote(s: str) -> Tuple[str, bool]:
    s = s.strip()
    quoted = False
    if s.startswith('"'):
        if len(s) == 1 or not s.endswith('"'):
            raise ValueError("missing close quote")
        s, quoted = s[1:-1], True
    return _UNESCAPE.sub(lambda m: _UNESCAPED[m.group(0)], s), quoted


def _parse_labels(body: str) -> Dict[str, str]:
    """``a="x",b="y"`` (a trailing comma allowed; a term without ``=``
    names the metric as ``__name__``; an empty value term is skipped)."""
    labels: Dict[str, str] = {}
    rest = body.strip()
    while rest:
        if rest[0] == ",":
            rest = rest[1:]
            if not rest:
                break
            if rest[0] == ",":
                raise ValueError(f"invalid labels {body!r}: two commas")
        at = _find_unquoted(rest, "=,}")
        if at >= 0 and rest[at] == "=":
            name_term, rest = rest[:at], rest[at + 1:]
            at = _find_unquoted(rest, ",}")
        else:
            name_term = "__name__"
        at = len(rest) if at < 0 else at
        term, rest = rest[:at].strip(), rest[at:].strip()
        if not term:
            continue
        name, quoted = _unquote(name_term)
        if not quoted and not _METRIC_NAME.match(name):
            raise ValueError(f"invalid label name in {body!r}")
        if term[0] != '"' or _closing_quote(term) != len(term) - 1:
            raise ValueError(f"invalid label value in {body!r}")
        if name.startswith("__") and name != "__name__":
            raise ValueError(f"reserved label name in {body!r}")
        if name in labels:
            raise ValueError(f"duplicate label {name!r} in {body!r}")
        labels[name] = _unquote(term)[0]
    return labels


def _number(s: str) -> float:
    if s != s.strip() or "_" in s:
        raise ValueError(f"invalid value {s!r}")
    try:
        return int(s)
    except ValueError:
        return float(s)


def _parse_sample(line: str) -> Tuple[str, Dict[str, str], float]:
    brace = _find_unquoted(line, "{")
    if brace < 0 or " # " in line[:brace]:
        end = _find_unquoted(line, " \t")
        name = line[:end].strip()
        if not _METRIC_NAME.match(name):
            raise ValueError(f"invalid metric name in {line!r}")
        labels, rest = {}, line[end + 1:]
    else:
        name = line[:brace].strip()
        close = _find_unquoted(line[brace:], "}") + brace
        labels = _parse_labels(line[brace + 1:close])
        if not name:
            if "__name__" not in labels:
                raise ValueError(f"no metric name in {line!r}")
            name = labels.pop("__name__")
        elif "__name__" in labels:
            raise ValueError(f"metric name given twice in {line!r}")
        rest = line[close + 1:]
    rest = rest.lstrip()
    sep = " " if " " in rest else "\t"
    fields = [f.strip() for f in rest.split(sep) if f.strip()]
    if not fields:
        return name, labels, float(rest)  # raises: no value
    if len(fields) > 1:
        _number(fields[-1])  # a timestamp, checked and not kept
    return name, labels, _number(fields[0])


_SUFFIXES = {"summary": ("_count", "_sum", ""),
             "histogram": ("_count", "_sum", "_bucket")}
_KINDS = frozenset(("counter", "gauge", "summary", "histogram",
                    "gaugehistogram", "unknown", "info", "stateset",
                    "untyped"))


def _close(family: str, kind: str) -> None:
    """A family ends (another begins, or the page does): its TYPE must
    have been one the format knows."""
    if family and kind not in _KINDS:
        raise ValueError(f"invalid metric type {kind!r} of {family!r}")


def parse_text(text: str) -> Iterator[Sample]:
    """The samples of a Prometheus text page (format 0.0.4) in order, as
    ``(name, labels, value)``: a histogram's ``_bucket``, ``_sum`` and
    ``_count`` lines are samples of their own, ``+Inf``, ``-Inf`` and
    ``NaN`` are floats, label values are unescaped, comments and a
    sample's timestamp are read and dropped.  It reads a page as
    ``prometheus_client.parser`` does, renaming included: a sample of a
    family typed ``counter`` whose name lacks ``_total`` gets it.  A
    malformed line or an unknown TYPE (a page torn mid-write) raises
    ``ValueError``."""
    family, kind, members = "", "untyped", ()
    for line in text.split("\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 2 or (len(parts) > 2
                                  and parts[1] not in ("HELP", "TYPE")):
                continue
            name = ""
            if len(parts) > 2:
                name, quoted = _unquote(parts[2])
                if not quoted and not _METRIC_NAME.match(name):
                    raise ValueError(f"invalid metric name in {line!r}")
            if parts[1] == "HELP":
                if name != family:
                    _close(family, kind)
                    family, kind, members = name, "untyped", (name,)
            elif parts[1] == "TYPE":
                if len(parts) < 4:
                    raise ValueError(f"TYPE without a type: {line!r}")
                if name != family:
                    _close(family, kind)
                family, kind = name, parts[3]
                members = tuple(name + s for s in _SUFFIXES.get(kind, ("",)))
            continue
        name, labels, value = _parse_sample(line)
        if name not in members:
            _close(family, kind)
            family, kind, members = "", "untyped", ()
        elif kind == "counter" and not family.endswith("_total"):
            name += "_total"
        yield name, labels, value
    _close(family, kind)
