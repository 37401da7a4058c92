"""The native control-plane engine: build, load and bind
``build/native/libkft_native.so``.  The port's copy of
``kubeflow_tpu/platform/native.py``, over its own sources in
``platform/csrc/`` (the same C ABI as the reference's ``native/``):

* ``kfp_*`` (``jsonpatch.cc``): JSON parse/serialize, RFC 6902 patch
  create/apply (the admission webhook's pod diff), RFC 7386 merge patch
  apply/create (``FakeKube``'s merge patches, ``runtime/apply.py``'s
  diff) and the compact canonical serializer;
* ``kfq_*`` (``workqueue.cc``): the delaying, rate-limited work queue of
  the controller runtime;
* ``kfpk_pack`` (``packer.cc``): best-fit-decreasing sequence packing;
* ``kfw_*`` (``wirecodec.cc``): the watch-event envelope scanner of the
  wire codec (``k8s/codec.py``).

The library is built on first use with ``g++ -O2 -std=c++17 -fPIC
-pthread``, one ``g++ -c`` per source, all started together, then one
link, into ``build/native/`` at the root of the checkout; it is rebuilt
when the hash of the sources and flags changes.  A process tries once:
a failed build or load is cached, every caller runs the Python engines,
and ``load_error()`` says why.  ``KF_NATIVE=0`` disables the engine (any
other value than ``0`` or ``1`` keeps the default, on).  ``loaded()``
never builds.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform import config

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libkft_native.so"
LIB_PATH = BUILD_DIR / LIB_NAME
SOURCES = ("jsonpatch.cc", "workqueue.cc", "packer.cc", "wirecodec.cc")
CXX = "g++"
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread"]
# Every component ships in the one library, so they load or fail
# together; the breakdown keeps native_engine_active{component} stable.
ENGINE_COMPONENTS = ("jsonpatch", "workqueue", "packer", "wirecodec")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_load_lock = threading.Lock()
_load_error: Optional[str] = None
# The last build of this process: seconds, and whether the library of
# this source hash was already there (no compiler ran).
last_build_seconds: Optional[float] = None
last_build_cached: Optional[bool] = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join([CXX, *CXXFLAGS]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def compile_commands(out_dir: Path) -> List[List[str]]:
    """One ``g++ -c`` per source, then the link into the library."""
    objs = [out_dir / (Path(s).stem + ".o") for s in SOURCES]
    cmds = [[CXX, *CXXFLAGS, "-c", str(CSRC / s), "-o", str(o)]
            for s, o in zip(SOURCES, objs)]
    cmds.append([CXX, *CXXFLAGS, "-shared", "-o", str(out_dir / LIB_NAME),
                 *map(str, objs)])
    return cmds


def build(out_dir: Path = BUILD_DIR, *, force: bool = False) -> Path:
    """Compile the library unless the one for this source hash exists
    (``force`` compiles regardless).  Processes that build at once take
    turns on a lock file; each compiles into a private directory and
    moves the library into place whole.  Raises when a compiler fails."""
    global last_build_seconds, last_build_cached
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    stamp = out_dir / (LIB_NAME + ".hash")
    digest = source_hash()
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and lib.exists() and stamp.exists() \
                and stamp.read_text() == digest:
            last_build_seconds = time.perf_counter() - t0
            last_build_cached = True
            return lib
        tmp = Path(tempfile.mkdtemp(dir=out_dir, prefix=".build-"))
        try:
            cmds = compile_commands(tmp)
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds[:-1]]
            failed = []
            for cmd, proc in zip(cmds, procs):
                out, _ = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    failed.append(f"{' '.join(cmd)}\n{out}")
            if failed:
                raise RuntimeError("g++ failed:\n" + "\n".join(failed))
            link = subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=300)
            if link.returncode != 0:
                raise RuntimeError(f"g++ link failed:\n{link.stdout}")
            os.replace(tmp / LIB_NAME, lib)
            stamp.write_text(digest)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    last_build_cached = False
    return lib


def _try_build() -> bool:
    """The one build attempt of a process; False (the reason kept for
    ``load_error``) when it fails."""
    global _load_error
    try:
        build()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _load_error = f"build failed: {e}"
        return False


def _knob_native() -> str:
    # A bad value shows at /debug/knobs as env-invalid; the default runs.
    try:
        return config.knob(
            "KF_NATIVE", "1",
            doc="'0' disables the native C++ engine, '1' enables it",
            validate=lambda v: None if v in ("0", "1")
            else "must be '0' or '1'")
    except ValueError:
        return "1"


def _set_engine_gauge(active: bool) -> None:
    from kubeflow_tpu_torch.platform.runtime import metrics

    for component in ENGINE_COMPONENTS:
        metrics.native_engine_active.labels(
            component=component).set(1.0 if active else 0.0)


def _finish_load(lib: Optional[ctypes.CDLL], error: Optional[str]
                 ) -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    _lib = lib
    _load_error = error
    _set_engine_gauge(lib is not None)
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    c_char_p, c_void_p = ctypes.c_char_p, ctypes.c_void_p
    i64, dbl, cint = ctypes.c_int64, ctypes.c_double, ctypes.c_int
    i64p = ctypes.POINTER(ctypes.c_int64)
    sigs = {
        # kfp: the JSON patch engine; strings come back malloc'd.
        "kfp_create_patch": ([c_char_p, c_char_p], c_void_p),
        "kfp_apply_patch": ([c_char_p, c_char_p], c_void_p),
        "kfp_canonical": ([c_char_p], c_void_p),
        "kfp_merge_apply": ([c_char_p, c_char_p], c_void_p),
        "kfp_merge_create": ([c_char_p, c_char_p], c_void_p),
        "kfp_last_error": ([], c_char_p),
        "kfp_free": ([c_void_p], None),
        # kfq: the work queue over int64 keys.
        "kfq_new": ([dbl, dbl], c_void_p),
        "kfq_delete": ([c_void_p], None),
        "kfq_add": ([c_void_p, i64, dbl], None),
        "kfq_add_rate_limited": ([c_void_p, i64], None),
        "kfq_forget": ([c_void_p, i64], None),
        "kfq_failures": ([c_void_p, i64], cint),
        "kfq_is_pending": ([c_void_p, i64], cint),
        "kfq_get": ([c_void_p, dbl], i64),
        "kfq_done": ([c_void_p, i64], None),
        "kfq_is_processing": ([c_void_p, i64], cint),
        "kfq_pending": ([c_void_p], i64),
        "kfq_shutdown": ([c_void_p], None),
        # kfpk: the packer.
        "kfpk_pack": ([i64p, i64, i64, i64p, i64p], i64),
        # kfw: the wire scanner.
        "kfw_scan_event": ([c_char_p, i64, i64p], cint),
        "kfw_last_error": ([], c_char_p),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _load() -> Optional[ctypes.CDLL]:
    global _load_attempted
    if _load_attempted:
        return _lib
    with _load_lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if _knob_native() == "0":
            return _finish_load(None, "disabled by KF_NATIVE=0")
        if not _try_build():
            return _finish_load(None, _load_error)
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
            _bind(lib)
        except (OSError, AttributeError) as e:
            return _finish_load(None, f"load failed: {e}")
        return _finish_load(lib, None)


def available() -> bool:
    """Load the engine (building it first if needed); True when it
    serves."""
    return _load() is not None


def loaded() -> bool:
    """True only when the library is already loaded: never builds (a
    first build takes seconds, too long under a store's lock)."""
    return _lib is not None


def preload() -> bool:
    """Load (and build) now, at a process's start, so no request pays
    for the first build."""
    return available()


def backend_info() -> str:
    return f"native:{LIB_PATH}" if available() else "python"


def load_error() -> Optional[str]:
    """Why the engine is not active (None while active or before the
    first load attempt)."""
    return _load_error


def engine_components() -> Dict[str, bool]:
    """Each component's state, the native_engine_active gauge's source."""
    active = available()
    return {c: active for c in ENGINE_COMPONENTS}


# -- JSON patch ---------------------------------------------------------------


class NativeError(Exception):
    pass


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise NativeError("native library unavailable")
    return lib


def _call_str(fn, *args: bytes) -> str:
    lib = _library()
    ptr = fn(*args)
    if not ptr:
        raise NativeError(lib.kfp_last_error().decode())
    try:
        return ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    finally:
        lib.kfp_free(ptr)


def create_patch_json(before_json: str, after_json: str) -> str:
    """RFC 6902 diff of two JSON documents."""
    lib = _library()
    return _call_str(lib.kfp_create_patch, before_json.encode(),
                     after_json.encode())


def apply_patch_json(doc_json: str, patch_json: str) -> str:
    lib = _library()
    return _call_str(lib.kfp_apply_patch, doc_json.encode(),
                     patch_json.encode())


def create_patch(before: Any, after: Any) -> List[Dict[str, Any]]:
    import json

    return json.loads(create_patch_json(json.dumps(before),
                                        json.dumps(after)))


def apply_patch(doc: Any, ops: List[Dict[str, Any]]) -> Any:
    import json

    return json.loads(apply_patch_json(json.dumps(doc), json.dumps(ops)))


# -- RFC 7386 merge patch -----------------------------------------------------


def merge_patch_apply(doc: Any, patch: Any) -> Any:
    import json

    lib = _library()
    return json.loads(_call_str(lib.kfp_merge_apply,
                                json.dumps(doc).encode(),
                                json.dumps(patch).encode()))


def merge_patch_create_json(before_json: str, after_json: str) -> str:
    """The merge patch turning one serialized document into another (the
    codec holds serialized documents already)."""
    lib = _library()
    return _call_str(lib.kfp_merge_create, before_json.encode(),
                     after_json.encode())


def merge_patch_create(before: Any, after: Any) -> Any:
    import json

    return json.loads(merge_patch_create_json(json.dumps(before),
                                              json.dumps(after)))


def canonical_json(doc_json: str) -> str:
    """Parse and re-serialize through the engine's compact serializer:
    byte-equal to ``json.dumps(obj, separators=(",", ":"),
    ensure_ascii=False)``."""
    lib = _library()
    return _call_str(lib.kfp_canonical, doc_json.encode())


# -- wire codec ---------------------------------------------------------------


# One unpack of the 12-slot out array beats twelve ctypes index reads.
_KFW_UNPACK = struct.Struct("=12q").unpack_from

WireScan = Tuple[str, bytes, Optional[bytes],
                 Optional[str], Optional[str], Optional[str]]


def wire_scanner() -> Optional[Callable[[bytes], WireScan]]:
    """The envelope scanner bound into one closure, or None without the
    library.  It takes one watch line and returns ``(etype,
    object_bytes, metadata_bytes_or_None, name, namespace,
    resourceVersion)``; an identity field is None when the scanner did
    not extract it (absent, escaped or not a string: parse the metadata
    to find out).  Raises NativeError on a line that does not scan.  The
    closure owns its out-buffer: one closure a thread."""
    lib = _load()
    if lib is None:
        return None
    scan = lib.kfw_scan_event
    last_error = lib.kfw_last_error
    out = (ctypes.c_int64 * 12)()
    unpack = _KFW_UNPACK

    def _scan(line: bytes) -> WireScan:
        if scan(line, len(line), out) != 0:
            raise NativeError(last_error().decode())
        (ts, te, os_, oe, ms, me,
         ns_s, ns_e, sp_s, sp_e, rv_s, rv_e) = unpack(out)
        return (
            line[ts:te].decode(),
            line[os_:oe],
            line[ms:me] if ms >= 0 else None,
            line[ns_s:ns_e].decode() if ns_s >= 0 else None,
            line[sp_s:sp_e].decode() if sp_s >= 0 else None,
            line[rv_s:rv_e].decode() if rv_s >= 0 else None,
        )

    return _scan


def wire_scan_event(line: bytes):
    """``(etype, object_bytes, metadata_bytes_or_None)`` of one line (a
    fresh scanner each call: for tests and one-off callers)."""
    scanner = wire_scanner()
    if scanner is None:
        raise NativeError("native library unavailable")
    etype, obj, meta, _, _, _ = scanner(line)
    return etype, obj, meta


# -- work queue ---------------------------------------------------------------


class NativeWorkQueue:
    """The ``kfq_*`` queue behind the Python ``_WorkQueue``'s interface.
    Requests map to int64 keys at the boundary; the heap, dedup, per-key
    exclusion and backoff run in C++.  ``metrics`` is the
    ``WorkQueueMetrics`` shim, its hooks fired where ``_WorkQueue`` fires
    them, so the ``workqueue_*`` series read the same from either
    engine."""

    def __init__(self, *, base_delay: float = 0.05, max_delay: float = 30.0,
                 metrics=None):
        lib = _library()
        self._lib = lib
        self._q = lib.kfq_new(base_delay, max_delay)
        self._base = base_delay
        self._max = max_delay
        self.metrics = metrics
        # The engine drops adds after shutdown silently; this flag keeps
        # the metric hooks from firing for them, as _WorkQueue's does.
        self._shutdown = False
        self._lock = threading.Lock()
        self._next_id = 0
        self._to_id: Dict[Any, int] = {}
        self._from_id: Dict[int, Any] = {}

    def _key_locked(self, req: Any) -> int:
        key = self._to_id.get(req)
        if key is None:
            key = self._next_id
            self._next_id += 1
            self._to_id[req] = key
            self._from_id[key] = req
        return key

    # The id maps and the C enqueue share one lock; kfq_get blocks
    # outside it, so done()'s prune checks kfq_is_processing: another
    # worker may have taken the key between kfq_done and the prune.

    def add(self, req: Any, *, delay: float = 0.0) -> None:
        with self._lock:
            if self._shutdown:
                return
            if self.metrics is not None:
                self.metrics.on_add(req, delay=delay)
            self._lib.kfq_add(self._q, self._key_locked(req), delay)

    def add_rate_limited(self, req: Any) -> None:
        with self._lock:
            if self._shutdown:
                return
            key = self._key_locked(req)
            if self.metrics is not None:
                # The engine's backoff, min(base * 2^failures, max).
                n = self._lib.kfq_failures(self._q, key)
                self.metrics.on_retry(req)
                self.metrics.on_add(
                    req, delay=min(self._base * (2 ** n), self._max))
            self._lib.kfq_add_rate_limited(self._q, key)

    def forget(self, req: Any) -> None:
        with self._lock:
            key = self._to_id.get(req)
            if key is not None:
                self._lib.kfq_forget(self._q, key)

    def failures(self, req: Any) -> int:
        with self._lock:
            key = self._to_id.get(req)
            return (self._lib.kfq_failures(self._q, key)
                    if key is not None else 0)

    def get(self, timeout: float = 0.2) -> Optional[Any]:
        """Pop a key and take its exclusion; pair every non-None return
        with ``done(key)``, in a ``finally``."""
        key = self._lib.kfq_get(self._q, timeout)  # blocks outside the lock
        if key < 0:
            return None
        with self._lock:
            req = self._from_id.get(key)
            if req is not None and self.metrics is not None:
                self.metrics.on_get(req)
        return req

    def done(self, req: Any) -> None:
        """Release the exclusion ``get`` took; the id maps drop a key with
        nothing pending, processing or backing off."""
        with self._lock:
            key = self._to_id.get(req)
            if key is None:
                return
            if self.metrics is not None and self._lib.kfq_is_processing(
                    self._q, key):
                self.metrics.on_done(req)
            self._lib.kfq_done(self._q, key)
            if (not self._lib.kfq_is_pending(self._q, key)
                    and not self._lib.kfq_is_processing(self._q, key)
                    and self._lib.kfq_failures(self._q, key) == 0):
                del self._to_id[req]
                del self._from_id[key]

    def pending(self) -> int:
        return int(self._lib.kfq_pending(self._q))

    def shut_down(self) -> None:
        with self._lock:
            self._shutdown = True
        self._lib.kfq_shutdown(self._q)

    def __del__(self):
        q = getattr(self, "_q", None)
        if q:
            self._q = None
            try:
                self._lib.kfq_delete(q)
            # kft: disable=R006 interpreter-shutdown __del__: ctypes may be gone
            except Exception:
                pass


# -- sequence packer ----------------------------------------------------------


def native_pack(lengths, row_len: int):
    """Best-fit-decreasing packing in the engine: ``(row_assignment,
    row_offset, n_rows)``, or None without the library.  Raises
    ValueError for a length < 1 or > row_len."""
    lib = _load()
    if lib is None:
        return None
    import numpy as np

    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    n = len(lengths)
    assignment = np.empty(n, dtype=np.int64)
    offset = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rows = lib.kfpk_pack(lengths.ctypes.data_as(i64p), n, int(row_len),
                         assignment.ctypes.data_as(i64p),
                         offset.ctypes.data_as(i64p))
    if rows < 0:
        raise ValueError(f"invalid document lengths for row_len={row_len}")
    return assignment, offset, int(rows)
