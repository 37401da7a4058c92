"""The wire codec: every watch and list byte the REST client reads, and
every body it writes, crosses here.  The port's copy of
``kubeflow_tpu/platform/k8s/codec.py``.  Three fast paths, each with a
Python path of the same semantics:

* ``decode_event``: one watch line -> ``(type, object)``.  Native: the
  engine's scanner (``csrc/wirecodec.cc``) finds the envelope's byte
  ranges and extracts the metadata identity fields (name, namespace,
  resourceVersion), so the admit and dedup path runs with no JSON parse;
  the object is a :class:`LazyResource` over the raw bytes whose
  :class:`LazyMeta` answers identity reads from the extracted fields,
  parses the small metadata slice when another metadata key is read, and
  defers the body until the informer admits the event.  A line the
  scanner refuses falls back to the Python path, per event.  Python:
  ``json.loads`` of the whole line.
* ``merge_patch_native``: the RFC 7386 diff in the engine
  (``kfp_merge_create``), ``{}`` mapped to None as ``runtime/apply.py``'s
  "no change"; apply.py falls back to its ``_diff`` walk and counts it
  (``count_merge_python``).
* ``encode``: object -> wire text.  A ``LazyResource`` never
  materialized passes its raw bytes through; dicts and frozen cache
  views serialize through ``json_default`` without a thaw copy.

The engine: ``KF_WIRE_CODEC`` = ``auto`` (native when the engine loads,
the default), ``native`` or ``python``; any other value keeps ``auto``.
``KF_NATIVE=0`` disables the library under either.  The per-call
``engine=`` override serves the three-way matrix of the tests.
"""
from __future__ import annotations

import json
import threading
from collections.abc import Mapping
from typing import Any, Iterator, Optional, Tuple

from kubeflow_tpu_torch.platform import config, native
from kubeflow_tpu_torch.platform.k8s.types import json_default

NativeError = native.NativeError

# Per-thread bound decoder closures (native.wire_scanner binds the
# ctypes entry point and an out-buffer into one callable; the buffer
# makes it thread-unsafe, hence one per thread).  The decoder is built
# lazily in decode_event's native branch.
_tls = threading.local()

# Monotonic per-process counters (GIL-atomic increments; read via
# ``stats()``): how many events took which path, and how many lazy
# objects were ever materialized: the laziness tests and the card's wire
# checks read these.
_stats = {
    "decode_native": 0,
    "decode_python": 0,
    "materialize": 0,
    "merge_native": 0,
    "merge_python": 0,
    "encode_raw": 0,
    "encode_python": 0,
}

_engine_cache: Optional[bool] = None


def _knob_codec() -> str:
    value = config.env("KF_WIRE_CODEC", "auto")
    return value if value in ("auto", "native", "python") else "auto"


def engine_native() -> bool:
    """Whether the codec's default engine is the native scanner.  The
    knob is read once per process (the decode path runs per event);
    tests flip engines with the explicit ``engine=`` arguments or
    ``reset_engine_cache()``."""
    global _engine_cache
    if _engine_cache is None:
        mode = _knob_codec()
        _engine_cache = mode != "python" and native.available()
    return _engine_cache


def reset_engine_cache() -> None:
    global _engine_cache
    _engine_cache = None


def stats() -> dict:
    return dict(_stats)


class LazyMeta:
    """The ``metadata`` mapping of a not-yet-materialized watch object.

    The native scanner hands the codec the metadata byte slice plus the
    three identity fields the admit/dedup hot path reads (name,
    namespace, resourceVersion) already extracted — those answer without
    any JSON parse at all.  Any other key (labels, ownerReferences,
    annotations, ...) decodes the metadata slice once, which is still an
    order of magnitude smaller than the body.  A None fast field means
    "not extracted" (absent, escaped, or non-string), never "absent" —
    the slow path decides.

    Read-only by design: there is no ``__setitem__``, so a write that
    would previously have been silently lost on materialization now
    fails loudly.  Informers materialize admitted objects before the
    store, so handlers only ever see plain dicts.
    """

    __slots__ = ("_raw", "_name", "_namespace", "_rv", "_full")

    def __init__(self, raw: bytes, name: Optional[str],
                 namespace: Optional[str], rv: Optional[str]):
        self._raw = raw
        self._name = name
        self._namespace = namespace
        self._rv = rv
        self._full: Optional[dict] = None

    def _parse(self) -> dict:
        if self._full is None:
            full = json.loads(self._raw)
            if not isinstance(full, dict):
                raise ValueError("metadata is not an object")
            self._full = full
        return self._full

    def _fast(self, key) -> Optional[str]:
        if key == "name":
            return self._name
        if key == "namespace":
            return self._namespace
        if key == "resourceVersion":
            return self._rv
        return None

    @property
    def parsed(self) -> bool:
        return self._full is not None

    # get/__getitem__ inline the fast-field compares instead of calling
    # _fast(): the three identity reads run once per watch event.

    def __getitem__(self, key):
        if self._full is None:
            if key == "name":
                v = self._name
            elif key == "namespace":
                v = self._namespace
            elif key == "resourceVersion":
                v = self._rv
            else:
                v = None
            if v is not None:
                return v
        return self._parse()[key]

    def get(self, key, default=None):
        if self._full is None:
            if key == "name":
                v = self._name
            elif key == "namespace":
                v = self._namespace
            elif key == "resourceVersion":
                v = self._rv
            else:
                v = None
            if v is not None:
                return v
        return self._parse().get(key, default)

    def __contains__(self, key) -> bool:
        if self._full is None and self._fast(key) is not None:
            return True
        return key in self._parse()

    def __bool__(self) -> bool:
        # ``meta(obj) or {}`` idioms must not force a parse when the fast
        # fields already prove the mapping is non-empty.
        if self._full is None and (
                self._name is not None or self._namespace is not None
                or self._rv is not None):
            return True
        return bool(self._parse())

    def __iter__(self) -> Iterator[str]:
        return iter(self._parse())

    def __len__(self) -> int:
        return len(self._parse())

    def keys(self):
        return self._parse().keys()

    def values(self):
        return self._parse().values()

    def items(self):
        return self._parse().items()

    def __eq__(self, other) -> bool:
        if isinstance(other, LazyMeta):
            return self._parse() == other._parse()
        if isinstance(other, dict):
            return self._parse() == other
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        state = "parsed" if self._full is not None else (
            f"lazy, {len(self._raw)}B")
        return f"LazyMeta({state})"


class LazyResource:
    """A watch-event object whose body decode is deferred.

    Holds the raw object bytes plus a :class:`LazyMeta` over the
    metadata slice (the only part of an object the admit/dedup path
    reads).  Any access beyond ``metadata`` materializes the full
    document once and delegates to it from then on.  Deliberately NOT a
    dict subclass: ``types.freeze``/``copy_resource`` dispatch on
    ``type(x) is dict`` and must not treat the unmaterialized stub as a
    document — informers call :func:`materialize` before storing, so
    caches and handlers only ever hold plain dicts.
    """

    __slots__ = ("_raw", "_meta", "_obj")

    def __init__(self, raw: bytes, meta: Optional[LazyMeta]):
        self._raw = raw
        self._meta = meta
        self._obj: Optional[dict] = None

    def _materialize(self) -> dict:
        if self._obj is None:
            _stats["materialize"] += 1
            obj = json.loads(self._raw)
            if not isinstance(obj, dict):
                raise ValueError(
                    f"watch object is not a JSON object: {obj!r}")
            self._obj = obj
        return self._obj

    @property
    def raw(self) -> Optional[bytes]:
        """The wire bytes, or None once materialized (a materialized
        body may have been handed out and mutated — the bytes can no
        longer be trusted to match)."""
        return None if self._obj is not None else self._raw

    @property
    def materialized(self) -> bool:
        return self._obj is not None

    # -- Mapping surface ------------------------------------------------------

    def __getitem__(self, key):
        if key == "metadata" and self._obj is None and self._meta is not None:
            return self._meta
        return self._materialize()[key]

    def get(self, key, default=None):
        if key == "metadata" and self._obj is None and self._meta is not None:
            return self._meta
        return self._materialize().get(key, default)

    def __contains__(self, key) -> bool:
        if key == "metadata" and self._obj is None and self._meta is not None:
            return True
        return key in self._materialize()

    def __iter__(self) -> Iterator[str]:
        return iter(self._materialize())

    def __len__(self) -> int:
        return len(self._materialize())

    def keys(self):
        return self._materialize().keys()

    def values(self):
        return self._materialize().values()

    def items(self):
        return self._materialize().items()

    def __eq__(self, other) -> bool:
        if isinstance(other, LazyResource):
            return self._materialize() == other._materialize()
        if isinstance(other, dict):
            return self._materialize() == other
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        state = "materialized" if self._obj is not None else (
            f"lazy, {len(self._raw)}B")
        return f"LazyResource({state})"


# Virtual Mapping so ``types.deep_get`` (which gates each step on
# ``isinstance(cur, Mapping)``) traverses the lazy stubs instead of
# answering its default — the admit path reads labels/ownerRefs through
# deep_get and a silent miss there would fail every shard filter open.
# Registration (not subclassing) keeps ``type(x) is dict`` dispatch in
# types.freeze/copy_resource treating the stubs as opaque.
Mapping.register(LazyResource)
Mapping.register(LazyMeta)


def _make_decoder():
    """Fuse scan and stub construction into one per-thread closure: the
    decode path runs once per watch event."""
    scan = native.wire_scanner()
    if scan is None:
        return None
    stats = _stats
    lazy_res, lazy_meta = LazyResource, LazyMeta

    def _decode(line: bytes) -> Tuple[str, "LazyResource"]:
        etype, obj_bytes, meta_bytes, name, ns, rv = scan(line)
        stats["decode_native"] += 1
        return etype, lazy_res(
            obj_bytes,
            lazy_meta(meta_bytes, name, ns, rv)
            if meta_bytes is not None else None)

    return _decode


def decode_event(line: bytes, *, engine: Optional[str] = None
                 ) -> Tuple[str, Any]:
    """Decode one watch line (``{"type": ..., "object": ...}``).

    Native engine: a single envelope scan, returning a LazyResource
    (identity fields pre-extracted, metadata slice and body decoded
    lazily); a scan failure falls back to the Python path, so a line
    the scanner cannot handle costs time, never correctness.  Python
    engine: full ``json.loads``.
    """
    if isinstance(line, str):
        line = line.encode()
    use_native = engine_native() if engine is None else engine == "native"
    if use_native:
        dec = getattr(_tls, "decode", None)
        if dec is None:
            dec = _make_decoder()
            if dec is not None:
                _tls.decode = dec
        if dec is not None:
            try:
                return dec(line)
            except (NativeError, ValueError):
                pass
    _stats["decode_python"] += 1
    evt = json.loads(line)
    return evt.get("type", ""), evt.get("object", {})


def materialize(obj: Any) -> Any:
    """Plain-dict form of a decoded watch object.  Informers call this
    once an event is admitted, before the object enters the store —
    everything downstream of the cache keeps seeing ordinary dicts."""
    if isinstance(obj, LazyResource):
        return obj._materialize()
    return obj


def encode(obj: Any, *, engine: Optional[str] = None) -> str:
    """Serialize an object for the wire.  A never-materialized
    LazyResource passes its raw bytes through untouched; dicts and
    frozen cache views serialize via ``json_default`` (no thaw copy).
    The ``engine`` override exists for the serialization leg of the
    3-way matrix — both engines must produce semantically identical
    documents."""
    use_native = engine_native() if engine is None else engine == "native"
    if use_native and isinstance(obj, LazyResource):
        raw = obj.raw
        if raw is not None:
            _stats["encode_raw"] += 1
            return raw.decode()
    if isinstance(obj, LazyResource):
        obj = obj._materialize()
    _stats["encode_python"] += 1
    return json.dumps(obj, default=json_default)


def merge_patch_native(current: Any, desired: Any) -> Optional[dict]:
    """RFC 7386 diff through the native engine, with apply.py's contract
    (``None`` when nothing differs).  Raises NativeError when the engine
    is unavailable — apply.py's ``_diff`` walk is the fallback."""
    patch_json = native.merge_patch_create_json(
        encode(current if current is not None else {}),
        encode(desired if desired is not None else {}))
    patch = json.loads(patch_json)
    _stats["merge_native"] += 1
    if patch == {}:
        return None
    return patch


def count_merge_python() -> None:
    """apply.py's fallback path reports itself here so ``stats()`` shows
    the split across engines."""
    _stats["merge_python"] += 1
