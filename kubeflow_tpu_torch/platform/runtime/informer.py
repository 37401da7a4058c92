"""Shared informer: a list+watch cache with handlers, indexers, a
periodic relist and the shard filter of the sharded control plane.  The
port's copy of ``kubeflow_tpu/platform/runtime/informer.py``.

One LIST seeds a thread-safe store, a watch thread applies the deltas,
resumed from the collection's resourceVersion (a watch ERROR, the 410 of
a compacted version, or a failed watch falls back to a relist, the store
rebuilt whole, never served half-empty), and a relist every
``resync_period`` guards against missed deltas.  Handlers get the store
replayed as ADDED, then the stream; a replayed event at a version the
store holds reaches no handler.  Indexers file objects under values
(client-go's ``cache.Indexers``), read back by ``index_list``.  Every
read is a zero-copy read-only view (``k8s/types.py`` ``FrozenResource``;
``thaw`` makes a private copy to write).

Admission is the decode boundary: over ``RestKubeClient`` a watch
delta arrives as a ``k8s/codec.py`` ``LazyResource``, whose identity
fields the admit filter and the dedup read without a parse;
``codec.materialize`` parses the body only once the delta is admitted,
before it enters the store, so the cache and the handlers hold plain
dicts and a dropped delta is never fully parsed.  Resyncs read keys
alone (``keys``) and materialize nothing.

Under sharding (``runtime/sharding.py``) an ``admit`` predicate keeps
the store to the replica's owned key ranges, relist and deltas alike,
and a ``shard_subscription`` pushes the same ranges to a server that
``supports_shard_filter``, so the stream itself carries only them;
``refilter`` re-applies both after a rebalance.  Unlike the reference's,
it breaks the watch under the mutation lock and the deltas the broken
stream still delivers are dropped, so the resume point stays older than
any event of a newly admitted range, none of which is lost.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.platform.k8s import codec
from kubeflow_tpu_torch.platform.k8s.types import (
    GVK,
    Resource,
    deep_get,
    freeze,
    meta,
    name_of,
    namespace_of,
)
from kubeflow_tpu_torch.platform.runtime import metrics, trace

log = logging.getLogger("kubeflow_tpu_torch.runtime.informer")

Handler = Callable[[str, Resource], None]  # (event_type, object)

# An indexer maps an object to the index values it files under, e.g. pods
# by their notebook-name label; values embed the namespace
# (``f"{ns}/{...}"``) when the informer spans namespaces.
IndexFunc = Callable[[Resource], List[str]]


def cache_or_client_list(cache, client, gvk: GVK,
                         namespace: Optional[str] = None, *,
                         label_selector: Optional[Dict[str, str]] = None,
                         on_degraded: Optional[Callable] = None
                         ) -> List[Resource]:
    """The cache-read contract: read the informer when it is wired and
    synced, a live LIST otherwise (an unsynced cache never answers
    "nothing").  A transient failure of the live LIST (errors.is_transient)
    with a cache that holds something serves the cache and tells
    ``on_degraded(exc)``; other errors propagate."""
    from kubeflow_tpu_torch.platform.k8s import errors

    if cache is not None and cache.has_synced:
        return cache.list(namespace, label_selector=label_selector)
    try:
        return client.list(gvk, namespace, label_selector=label_selector)
    except errors.ApiError as e:
        if cache is None or not errors.is_transient(e):
            raise
        if not cache.has_synced and len(cache) == 0:
            raise  # an empty, never-synced cache has nothing to degrade to
        if on_degraded is not None:
            on_degraded(e)
        return cache.list(namespace, label_selector=label_selector)


def cache_or_client_get(cache, client, gvk: GVK, name: str,
                        namespace: Optional[str] = None, *,
                        read_through: bool = False,
                        on_degraded: Optional[Callable] = None
                        ) -> Optional[Resource]:
    """One object by the same contract; None when it is not found.
    ``read_through=True`` confirms a cache miss with one live GET (an
    object just created may not have reached the cache).  A transient
    live failure answers the cache's object, or raises on a miss (a
    degraded miss is not a NotFound)."""
    from kubeflow_tpu_torch.platform.k8s import errors

    if cache is not None and cache.has_synced:
        obj = cache.get(name, namespace)
        if obj is not None or not read_through:
            return obj
    try:
        return client.get(gvk, name, namespace)
    except errors.NotFound:
        return None
    except errors.ApiError as e:
        if cache is None or not errors.is_transient(e):
            raise
        obj = cache.get(name, namespace)
        if obj is None:
            raise
        if on_degraded is not None:
            on_degraded(e)
        return obj


class Informer:
    def __init__(self, client, gvk: GVK, *, namespace: Optional[str] = None,
                 resync_period: float = 3600.0,
                 indexers: Optional[Dict[str, IndexFunc]] = None,
                 admit: Optional[Callable[[Resource], bool]] = None):
        self.client = client
        self.gvk = gvk
        self.namespace = namespace
        self.resync_period = resync_period
        # The shard filter: a predicate over the object deciding whether
        # this replica caches it, applied at relist and to every delta,
        # so the store and its indexes hold only the owned key ranges.
        # Its answers change with a rebalance: refilter() after one.
        self.admit = admit
        # The server-side companion of admit: a callable returning the
        # ShardFilter spec this replica subscribes to (None: unfiltered),
        # sent with LIST and WATCH to a client that advertises
        # ``supports_shard_filter``.  admit stays the correctness layer:
        # the server filter is fail-open, so it may deliver a superset of
        # what admit accepts, never a subset.
        self.shard_subscription: Optional[Callable[[], Optional[str]]] = None
        self.events_seen = 0       # relist items + watch deltas observed
        self.events_admitted = 0   # ... that passed admit into the store
        self._store: Dict[Tuple[str, str], Resource] = {}
        # The read lock; _mutate_lock serializes whole mutations (one
        # delta, one relist, a refilter's relist from the coordinator's
        # thread) without blocking reads behind a LIST: deltas queued
        # during a LIST apply after its swap, in stream order.
        self._lock = threading.RLock()
        self._mutate_lock = threading.RLock()
        # Collapses concurrent refilter() calls, and the last refilter's
        # dedup token (the coordinator's change-event epoch): sharers of
        # one informer refilter it one after another on the same event,
        # and only the first does the work.
        self._refilter_gate = threading.Lock()
        self._last_refilter_token = None
        self._synced = threading.Event()
        self._stop = threading.Event()
        # The current watch's breaker: refilter() sets it to tear down a
        # stream whose server-side filter went stale; _run replaces it
        # before each establishment and stop() sets both.
        self._stream_stop = threading.Event()
        self._handlers: List[Handler] = []
        self._thread: Optional[threading.Thread] = None
        # Monotonic times of the last completed relist (None before the
        # first) and of start(): informer_last_sync_age_seconds.
        self.last_sync_monotonic: Optional[float] = None
        self.started_monotonic: Optional[float] = None
        self._indexers: Dict[str, IndexFunc] = dict(indexers or {})
        # indexer -> value -> {store key: object}, and (indexer, key) ->
        # the values the key is filed under.
        self._indexes: Dict[str, Dict[str, Dict[Tuple[str, str], Resource]]] = {
            name: {} for name in self._indexers
        }
        self._key_values: Dict[Tuple[str, Tuple[str, str]], List[str]] = {}
        # namespace -> {store key: object}: list(namespace=) and
        # keys(namespace=) in O(matches).
        self._by_ns: Dict[str, Dict[Tuple[str, str], Resource]] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Informer":
        """Idempotent while running (every controller sharing the
        informer starts it; the first call spawns the thread).  Raises
        after stop(): a stopped informer still reports has_synced, and a
        silent restart would serve a frozen cache."""
        if self._stop.is_set():
            raise RuntimeError(
                f"informer for {self.gvk.kind} was stopped; informers are "
                "not restartable — build a new one")
        if self._thread is not None and self._thread.is_alive():
            return self
        self.started_monotonic = time.monotonic()
        metrics.register_informer(self)
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.gvk.kind}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._stream_stop.set()
        metrics.deregister_informer(self)

    def wait_for_sync(self, timeout: float = 30.0) -> bool:
        return self._synced.wait(timeout)

    @property
    def has_synced(self) -> bool:
        return self._synced.is_set()

    def add_handler(self, handler: Handler) -> None:
        """Register for deltas; the objects already in the store are
        replayed as ADDED first."""
        with self._lock:
            self._handlers.append(handler)
            existing = list(self._store.values())
        for obj in existing:
            handler("ADDED", freeze(obj))

    # -- read API ------------------------------------------------------------

    def get(self, name: str, namespace: Optional[str] = None) -> Optional[Resource]:
        with trace.span("informer.get", kind=self.gvk.kind):
            with self._lock:
                obj = self._store.get((namespace or "", name))
            return freeze(obj) if obj is not None else None

    def list(self, namespace: Optional[str] = None, *,
             label_selector: Optional[Dict[str, str]] = None) -> List[Resource]:
        with trace.span("informer.list", kind=self.gvk.kind), self._lock:
            if namespace is not None:
                refs = list(self._by_ns.get(namespace, {}).values())
            else:
                refs = list(self._store.values())
            if label_selector:
                def matches(o):
                    labels = deep_get(o, "metadata", "labels", default={}) or {}
                    return all(labels.get(k) == v
                               for k, v in label_selector.items())

                refs = [o for o in refs if matches(o)]
            return [freeze(o) for o in refs]

    def keys(self, namespace: Optional[str] = None) -> List[Tuple[str, str]]:
        """(namespace, name) pairs in the cache: the resync's read, which
        touches no object."""
        with self._lock:
            if namespace is not None:
                return list(self._by_ns.get(namespace, {}).keys())
            return list(self._store.keys())

    def index_list(self, indexer: str, value: str) -> List[Resource]:
        """The objects ``indexer`` files under ``value``, in O(matches)."""
        with trace.span("informer.index_list", kind=self.gvk.kind), self._lock:
            bucket = self._indexes[indexer].get(value)
            return [freeze(o) for o in bucket.values()] if bucket else []

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    # -- internals -----------------------------------------------------------

    def _key(self, obj: Resource) -> Tuple[str, str]:
        return (namespace_of(obj) or "", name_of(obj))

    def _index_drop(self, key: Tuple[str, str]) -> None:
        """Unfile ``key`` from every index (lock held)."""
        for name in self._indexers:
            vals = self._key_values.pop((name, key), None)
            if not vals:
                continue
            idx = self._indexes[name]
            for v in vals:
                bucket = idx.get(v)
                if bucket is not None:
                    bucket.pop(key, None)
                    if not bucket:
                        del idx[v]

    def _index_set(self, key: Tuple[str, str], obj: Resource) -> None:
        """(Re)file ``key`` under its current index values (lock held)."""
        self._index_drop(key)
        for name, fn in self._indexers.items():
            try:
                vals = fn(obj) or []
            except Exception:
                log.exception("indexer %s failed", name)
                vals = []
            if vals:
                self._key_values[(name, key)] = vals
                idx = self._indexes[name]
                for v in vals:
                    idx.setdefault(v, {})[key] = obj

    def _current_filter(self) -> Optional[str]:
        """The shard-filter spec to send with LIST and WATCH now, or None
        for unfiltered: no subscription, a client that cannot filter, or
        a subscription that raises all stream unfiltered (only slower; a
        wrongly filtered stream would starve the reconcilers)."""
        if self.shard_subscription is None:
            return None
        if not getattr(self.client, "supports_shard_filter", False):
            return None
        try:
            return self.shard_subscription()
        except Exception:
            log.exception("informer %s: shard subscription failed; "
                          "streaming unfiltered", self.gvk.kind)
            return None

    def _relist(self) -> Optional[str]:
        """Rebuild the store from a full LIST, notifying the differences;
        returns the collection resourceVersion to resume the watch from
        (None when the client gives none: the watch then replays, and
        _apply dedups it)."""
        with self._mutate_lock:
            return self._relist_locked()

    def _relist_locked(self) -> Optional[str]:
        # The ranged relist: the subscription rides the LIST too, so a
        # rebalance re-seeds only the owned ranges.
        t0 = time.monotonic()
        flt = self._current_filter()
        kw = {} if flt is None else {"shard_filter": flt}
        if hasattr(self.client, "list_with_rv"):
            items, rv = self.client.list_with_rv(self.gvk, self.namespace,
                                                 **kw)
        else:
            items, rv = self.client.list(self.gvk, self.namespace,
                                         **kw), None
        self.events_seen += len(items)
        if self.admit is not None:
            items = [o for o in items if self._admitted(o)]
        self.events_admitted += len(items)
        fresh = {self._key(o): o for o in items}
        by_ns: Dict[str, Dict[Tuple[str, str], Resource]] = {}
        for key, obj in fresh.items():
            by_ns.setdefault(key[0], {})[key] = obj
        with self._lock:
            old = self._store
            self._store = fresh
            self._by_ns = by_ns
            if self._indexers:
                self._indexes = {name: {} for name in self._indexers}
                self._key_values.clear()
                for key, obj in fresh.items():
                    self._index_set(key, obj)
            handlers = list(self._handlers)
        for key, obj in fresh.items():
            prior = old.get(key)
            if prior is None:
                self._notify(handlers, "ADDED", obj)
            elif (meta(prior).get("resourceVersion")
                  != meta(obj).get("resourceVersion")):
                self._notify(handlers, "MODIFIED", obj)
        for key, obj in old.items():
            if key not in fresh:
                self._notify(handlers, "DELETED", obj)
        self.last_sync_monotonic = time.monotonic()
        metrics.informer_relist_duration_seconds.labels(
            kind=self.gvk.kind).observe(self.last_sync_monotonic - t0)
        return rv

    @staticmethod
    def _notify(handlers, etype: str, obj: Resource) -> None:
        view = freeze(obj)
        for h in handlers:
            try:
                h(etype, view)
            except Exception:
                log.exception("informer handler failed")

    def _admitted(self, obj: Resource) -> bool:
        """The shard filter's verdict on one object; a filter that raises
        admits (over-caching is benign, under-caching starves the
        reconcilers)."""
        try:
            return self.admit is None or bool(self.admit(obj))
        except Exception:
            log.exception("informer %s: admit filter failed", self.gvk.kind)
            return True

    def refilter(self, *, relist: bool = True, token=None) -> int:
        """Re-apply the admit filter after its answers changed (a shard
        rebalance).  Keys it now rejects leave the store and the indexes
        with no handler notification: a shard moving to another replica
        is not a deletion.  With ``relist`` (an acquisition) one relist
        follows, so the newly admitted ranges land and notify as ADDED:
        the moved range's resync.  ``token`` (the coordinator's
        change-event epoch) dedupes a shared informer: only the first
        call with a token does the work.  Returns the keys dropped."""
        if self.admit is None:
            return 0
        if token is not None:
            with self._lock:
                if token == self._last_refilter_token:
                    return 0
                self._last_refilter_token = token
        if not self._refilter_gate.acquire(blocking=False):
            return 0  # a concurrent refilter is already doing this work
        try:
            return self._refilter_gated(relist=relist)
        finally:
            self._refilter_gate.release()

    def _refilter_gated(self, *, relist: bool) -> int:
        with self._mutate_lock:
            with self._lock:
                doomed = [key for key, o in self._store.items()
                          if not self._admitted(o)]
                for key in doomed:
                    del self._store[key]
                    bucket = self._by_ns.get(key[0])
                    if bucket is not None:
                        bucket.pop(key, None)
                        if not bucket:
                            del self._by_ns[key[0]]
                    self._index_drop(key)
            if relist:
                try:
                    self._relist_locked()
                except Exception:
                    log.warning("informer %s: refilter relist failed "
                                "(the next scheduled relist recovers)",
                                self.gvk.kind, exc_info=True)
            if self.shard_subscription is not None:
                # Break the live watch, established under the old
                # subscription, while the mutation lock is held: what the
                # old stream still delivers is dropped (_apply), so the
                # last version applied stays older than any event the old
                # subscription filtered out, and _run resumes from it
                # under the new subscription, the server replaying the
                # gap under the new filter.
                self._stream_stop.set()
        return len(doomed)

    def _apply(self, etype: str, obj: Resource,
               stream_stop: Optional[threading.Event] = None) -> bool:
        """Apply one delta; False, with nothing applied, once the stream
        it came from was broken (the next establishment replays it)."""
        with self._mutate_lock:
            if stream_stop is not None and stream_stop.is_set():
                return False
            self.events_seen += 1
            if not self._admitted(obj):
                # Not our shard: skip the delta without evicting a stored
                # copy.  Eviction is refilter()'s, at the lease's release:
                # while a shard drains the filter already answers False
                # and in-flight reconciles still read these objects.
                return True
            self.events_admitted += 1
            # The decode boundary: only an admitted delta is parsed whole.
            obj = codec.materialize(obj)
            with self._lock:
                handlers = list(self._handlers)
                key = self._key(obj)
                if etype == "DELETED":
                    if self._store.pop(key, None) is None:
                        return True  # already gone; don't replay it
                    bucket = self._by_ns.get(key[0])
                    if bucket is not None:
                        bucket.pop(key, None)
                        if not bucket:
                            del self._by_ns[key[0]]
                    self._index_drop(key)
                elif etype in ("ADDED", "MODIFIED"):
                    prior = self._store.get(key)
                    if prior is not None and meta(prior).get(
                        "resourceVersion"
                    ) == meta(obj).get("resourceVersion"):
                        # A replay of the version the store holds (a watch
                        # re-established without a resume point).
                        return True
                    self._store[key] = obj
                    self._by_ns.setdefault(key[0], {})[key] = obj
                    self._index_set(key, obj)
                else:
                    return True  # BOOKMARK etc.
            self._notify(handlers, etype, obj)
            return True

    def _run(self) -> None:
        deadline = 0.0
        rv: Optional[str] = None
        failures = 0
        while not self._stop.is_set():
            try:
                if rv is None or time.monotonic() >= deadline:
                    # First sync or the scheduled relist; in between, a
                    # re-established watch resumes from the last version.
                    rv = self._relist()
                    self._synced.set()
                    failures = 0
                    deadline = time.monotonic() + self.resync_period
                # A fresh breaker each establishment: refilter() sets the
                # current one to re-establish under a new subscription,
                # resumed from the last version applied.
                stream_stop = threading.Event()
                self._stream_stop = stream_stop
                if self._stop.is_set():
                    break  # stop() raced the swap; open no stream
                flt = self._current_filter()
                kw = {} if flt is None else {"shard_filter": flt}
                for etype, obj in self.client.watch(
                    self.gvk, self.namespace, resource_version=rv,
                    stop=stream_stop, **kw,
                ):
                    if etype == "ERROR":
                        # The resume version was compacted (410): relist,
                        # after the transport path's pause.
                        metrics.informer_watch_restarts_total.labels(
                            kind=self.gvk.kind).inc()
                        rv = None
                        self._stop.wait(1.0)
                        break
                    if not self._apply(etype, obj, stream_stop):
                        break
                    new_rv = meta(obj).get("resourceVersion")
                    if new_rv is not None:
                        rv = new_rv
                    if time.monotonic() >= deadline:
                        rv = None  # the scheduled relist
                        break
            except Exception:
                if not self._stop.is_set():
                    log.warning("informer %s: watch failed, relisting",
                                self.gvk.kind, exc_info=True)
                    metrics.informer_watch_restarts_total.labels(
                        kind=self.gvk.kind).inc()
                    rv = None
                    # Exponential backoff on consecutive failures: a
                    # persistent error must not relist every second.
                    failures += 1
                    self._stop.wait(min(1.0 * 2 ** (failures - 1), 30.0))
