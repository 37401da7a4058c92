"""Sharded HA control plane: lease-owned keyspace shards.  The port's
copy of ``kubeflow_tpu/platform/runtime/sharding.py``.

One controller process with full-keyspace informers caps the platform at
one core's watch traffic and makes every crash a full-fleet stall.  This
module partitions the reconcile keyspace by a STABLE hash of
``namespace/name`` into ``num_shards`` ranges and lets N replicas own
them through renewable ``coordination.k8s.io/v1`` Leases — the same
lease discipline client-go's leaderelection uses, applied per shard
instead of per process.  Each replica:

* announces itself with a **membership lease** (``<name>-member-<id>``),
  renewed on the same cadence as shard leases, so every replica can
  compute the live member count M;
* holds up to ``ceil(num_shards / M)`` **shard leases**
  (``<name>-shard-<i>``): renews its own, acquires free/expired ones,
  and *releases* its highest-numbered excess when M grows — that is the
  join-rebalance: a joining replica becomes visible through its
  membership lease, incumbents shed shards, the joiner acquires them and
  resyncs only the moved range (Controller + Informer react through the
  listener callback);
* on crash, simply stops renewing: its shard leases expire after
  ``lease_seconds`` and survivors absorb the ranges.

Cross-process per-key exclusion (the work queue's invariant, extended
across replicas) is enforced at the WRITE boundary by lease fencing:
``FencedClient`` wraps a replica's client and refuses any write
performed on behalf of a reconcile whose key's shard this replica cannot
prove it still holds.  "Prove" means the local renewal clock is inside
the lease duration — a replica that was paused (GC, partition) past its
lease MUST fence itself before its next write: ``check_fence`` first
tries one synchronous confirm-renew against the apiserver and, failing
that, drops the shard and raises ``FencingError`` so the write never
reaches the wire.  The fencing token is the lease's ``leaseTransitions``
(bumped on every ownership change); every successful write is logged
with its token so tests assert no key was written under two different
tokens in overlapping ownership windows.

The hash, the lease specs and the filter's wire form are the
reference's bit for bit, so a fleet that mixes the two packages, or a
restart onto the port, agrees on who owns what.  Standard library only.
"""
from __future__ import annotations

import datetime
import logging
import math
import threading
import time
import uuid
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from kubeflow_tpu_torch.platform import config
from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import (
    LEASE,
    deep_get,
    gvk_of,
    name_of,
    namespace_of,
)

log = logging.getLogger("kubeflow_tpu_torch.runtime.sharding")

# Default timings mirror runtime/leader.py (client-go scaled down).  The
# lease TTL is the failover bound: a dead replica's ranges are absorbable
# after this many seconds, and a paused replica must fence itself once its
# last renewal is older than this.  (The shard COUNT knob,
# CONTROLLER_SHARDS, belongs to the controller binary, which the port
# does not have yet: it decides whether a coordinator exists at all.)
DEFAULT_LEASE_SECONDS = config.env_float("CONTROLLER_SHARD_LEASE_SECONDS", 15.0)
DEFAULT_RENEW_SECONDS = config.env_float("CONTROLLER_SHARD_RENEW_SECONDS", 5.0)
DEFAULT_RETRY_SECONDS = config.env_float("CONTROLLER_SHARD_RETRY_SECONDS", 2.0)

TIME_FORMAT = "%Y-%m-%dT%H:%M:%S.%fZ"

WRITE_VERBS = frozenset({
    "create", "update", "update_status", "patch", "patch_status", "delete",
})


# -- stable keyspace hash ------------------------------------------------------
#
# FNV-1a over the utf-8 bytes of "namespace/name".  NOT Python's hash():
# that is salted per process (PYTHONHASHSEED), and a shard map that moves
# on every restart would turn each rollout into a full-keyspace resync.
# Stability across interpreter versions/processes is pinned by the
# tests against hardcoded values.

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619


def stable_key_hash(namespace: str, name: str) -> int:
    """32-bit FNV-1a of ``namespace/name`` — process-independent."""
    h = _FNV_OFFSET
    for b in f"{namespace}/{name}".encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFF
    return h


def shard_of(namespace: str, name: str, num_shards: int) -> int:
    """The shard owning key ``namespace/name`` — every key maps to exactly
    one of ``range(num_shards)``."""
    return stable_key_hash(namespace, name) % num_shards


class ShardFilter:
    """A server-side shard subscription: which keys a watch/list stream
    should carry, evaluated at the APISERVER (HttpKube/FakeKube) so a
    replica's stream never contains bytes its ``admit`` would drop.

    Wire form (the ``shardFilter`` query param):

        v1:<num_shards>:<shard,shard,...>:<source>

    ``source`` names how the server derives the SHARD KEY from an object
    — it must mirror the key derivation of the informer's admit mapper:

    * ``self``          — the object's own ``namespace/name`` (primary
      kinds, whose reconcile key is the object itself);
    * ``label=<key>``   — ``namespace/<label value>`` (secondary kinds
      mapped to their parent by a label, e.g. a Notebook's pods via
      ``notebook-name``);
    * ``owner=<Kind>``  — ``namespace/<controller ownerRef name>`` where
      the controlling ownerReference has that kind (children created by
      ``apply.create_or_update``);
    * ``involved``      — core/v1 Event streams: candidate keys derived
      from ``involvedObject.name`` — the name itself, the name with a
      trailing ``-<ordinal>`` stripped (a StatefulSet pod is always
      ``<sts>-<ordinal>``), and each with a trailing ``-s<i>`` slice
      suffix stripped (the platform's multislice STS naming).  The
      event is delivered when ANY candidate's shard is subscribed, so
      this is a strict superset of every admit mapper that resolves an
      event to its object or that object's owner by name.

    FAIL-OPEN is the safety contract: an object whose source yields no
    key (label missing, no controlling ref of the kind) is DELIVERED and
    the client-side ``admit`` stays the correctness layer — server
    filtering may only ever remove events admit would also drop, so a
    source that does not apply to some object can cost bytes, never
    keys.  Everything else (unknown source, malformed spec) parses to
    None at the server, i.e. an unfiltered stream.
    """

    __slots__ = ("num_shards", "shards", "source")

    def __init__(self, num_shards: int, shards: FrozenSet[int],
                 source: str = "self"):
        self.num_shards = num_shards
        self.shards = frozenset(shards)
        self.source = source

    def spec(self) -> str:
        return "v1:{}:{}:{}".format(
            self.num_shards, ",".join(str(s) for s in sorted(self.shards)),
            self.source)

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["ShardFilter"]:
        """Parse a wire spec; None (unfiltered) for anything malformed —
        a server that cannot understand a subscription must deliver
        everything rather than silently drop keys."""
        if not spec:
            return None
        parts = spec.split(":", 3)
        if len(parts) != 4 or parts[0] != "v1":
            return None
        try:
            num_shards = int(parts[1])
            shards = frozenset(int(s) for s in parts[2].split(",") if s)
        except ValueError:
            return None
        source = parts[3]
        if num_shards <= 0:
            return None
        if source not in ("self", "involved") and not source.startswith(
                ("label=", "owner=")):
            return None
        return cls(num_shards, shards, source)

    def _key_name(self, md: dict) -> Optional[str]:
        if self.source == "self":
            return md.get("name")
        if self.source.startswith("label="):
            return (md.get("labels") or {}).get(self.source[6:])
        if self.source.startswith("owner="):
            kind = self.source[6:]
            for ref in md.get("ownerReferences") or ():
                if ref.get("controller") and ref.get("kind") == kind:
                    return ref.get("name")
            return None
        return None

    @staticmethod
    def _involved_candidates(obj) -> list:
        """Key-name candidates for an ``involved`` source: the involved
        object's name plus its ordinal- and slice-suffix-stripped forms
        (every name an event→owner admit mapper could resolve to)."""
        name = (obj.get("involvedObject") or {}).get("name")
        if not name:
            return []
        cands = [name]
        prefix, _, tail = name.rpartition("-")
        if prefix and tail.isdigit():
            cands.append(prefix)
        for c in list(cands):
            prefix, _, tail = c.rpartition("-")
            if prefix and tail.startswith("s") and tail[1:].isdigit():
                cands.append(prefix)
        return cands

    def admits(self, obj) -> bool:
        """Whether the stream should carry this object.  Fail-open: no
        derivable key -> deliver."""
        md = obj.get("metadata") or {}
        ns = md.get("namespace") or ""
        if self.source == "involved":
            cands = self._involved_candidates(obj)
            if not cands:
                return True
            return any(shard_of(ns, name, self.num_shards) in self.shards
                       for name in cands)
        name = self._key_name(md)
        if not name:
            return True
        return shard_of(ns, name, self.num_shards) in self.shards


class FencingError(errors.Conflict):
    """A write was refused because this replica no longer (provably) owns
    the key's shard lease.  Subclasses Conflict deliberately: the
    controller runtime treats it as the optimistic-concurrency happy path
    (requeue, never dead-letter) — and the requeued key is then dropped at
    dequeue by the ownership filter, because it belongs to another replica
    now."""


def _format(dt: datetime.datetime) -> str:
    return dt.strftime(TIME_FORMAT)


def _parse(value: Optional[str]) -> Optional[datetime.datetime]:
    if not value:
        return None
    for fmt in (TIME_FORMAT, "%Y-%m-%dT%H:%M:%SZ"):
        try:
            return datetime.datetime.strptime(value, fmt).replace(
                tzinfo=datetime.timezone.utc
            )
        except ValueError:
            continue
    return None


# -- fence context -------------------------------------------------------------
#
# Which reconcile a write belongs to.  Controller._reconcile_one sets the
# current request around the reconcile; FencedClient reads it to decide
# which shard a write must be fenced on.  FlightPool.run captures and
# restores it onto its worker threads, so a reconcile's fanned-out
# secondary writes fence on the same key as its inline ones.

_ctx = threading.local()


def current_request() -> Optional[Tuple[str, str]]:
    return getattr(_ctx, "request", None)


def set_current_request(req: Optional[Tuple[str, str]]) -> None:
    _ctx.request = req


# Listener signature: (acquired_shards, released_shards) — fired OUTSIDE
# the coordinator lock, from the coordinator loop thread (or from the
# worker thread that fenced itself).
ShardListener = Callable[[Set[int], Set[int]], None]


class ShardCoordinator:
    """Contend for the shard leases of one controller manager.

    ``owns_key``/``owned`` are cheap local reads for the enqueue/dequeue
    filters; ``check_fence`` is the write-boundary proof.  Lifecycle:
    ``start()`` spawns the renew loop, ``stop()`` releases everything
    (clean shutdown — survivors take over immediately), ``crash()`` stops
    renewing WITHOUT releasing (the chaos kill — survivors wait out the
    TTL), ``pause()/resume()`` freeze renewals with the loop alive (the
    split-brain simulation: a paused-but-alive replica whose lease
    expires under it must fence itself before its next write).
    """

    def __init__(
        self,
        client,
        *,
        name: str = "kubeflow-tpu-ctrlplane",
        num_shards: int = 8,
        namespace: str = "kubeflow",
        identity: Optional[str] = None,
        lease_seconds: float = DEFAULT_LEASE_SECONDS,
        renew_seconds: float = DEFAULT_RENEW_SECONDS,
        retry_seconds: float = DEFAULT_RETRY_SECONDS,
        now: Optional[Callable[[], datetime.datetime]] = None,
    ):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.client = client
        self.name = name
        self.num_shards = num_shards
        self.namespace = namespace
        self.identity = identity or f"{name}-{uuid.uuid4().hex[:8]}"
        self.lease_seconds = lease_seconds
        self.renew_seconds = renew_seconds
        self.retry_seconds = retry_seconds
        self._now = now or (
            lambda: datetime.datetime.now(datetime.timezone.utc)
        )
        self._lock = threading.Lock()
        self._owned: Set[int] = set()
        # Shards being handed over voluntarily: still leased (in-flight
        # reconciles may finish their writes — check_fence allows them)
        # but closed to NEW work (owns_key answers False so nothing else
        # dequeues).  The lease is only released once every registered
        # drain hook reports the shard quiet — the clean-handover half of
        # the no-overlapping-writes invariant (the crash half is the TTL).
        self._draining: Set[int] = set()
        # Callables (shard) -> bool, True when the caller has nothing in
        # flight for the shard.  Controllers register one over their
        # in-flight reconcile table.
        self._drain_hooks: List[Callable[[int], bool]] = []
        # shard -> monotonic timestamp taken BEFORE the renew API call was
        # issued (conservative: the server stamped renewTime at or after
        # this), so ``renewed_at + lease_seconds`` never outlives the real
        # expiry another replica computes from the lease itself.
        self._renewed_at: Dict[int, float] = {}
        # shard -> leaseTransitions at our last renew (the fencing token).
        self._tokens: Dict[int, int] = {}
        self._listeners: List[ShardListener] = []
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Listener dispatch runs on its OWN thread (started with the
        # loop): a listener reaction to an acquisition is a full relist
        # per informer, and running that inline in _tick would stall the
        # renewals of every other owned shard past their TTL — the exact
        # flapping _quiet()'s non-blocking design exists to prevent.
        # The queue preserves event order; before start() (unit tests
        # driving _tick() by hand) dispatch falls back to inline.
        self._events: "list" = []
        self._events_cond = threading.Condition()
        self._dispatch_thread: Optional[threading.Thread] = None
        # Monotonically increasing id per change event, exposed as
        # ``current_event_epoch`` while that event's listeners run.  Two
        # controllers sharing one informer both refilter it on the same
        # event; the informer dedupes by this token so the shared cache
        # pays ONE relist per rebalance, not one per sharer.
        self._epoch = 0
        self.current_event_epoch: Optional[int] = None
        self._last_scan: Dict[int, dict] = {}
        # (shard, action, monotonic_time, write_deadline) — action in
        # acquire|renew-lost|release|fenced|crash.  ``write_deadline`` is
        # the last instant this replica could legitimately have written
        # the shard: the event time for voluntary closes (release/fenced
        # — ownership is dropped before the event is logged), and
        # ``last_renew + lease_seconds`` for involuntary ones (renew-lost/
        # crash — the fencing clock keeps stale writes out past that
        # point, and a successor cannot acquire before it).  The chaos
        # suite builds its no-overlapping-ownership-windows assertion
        # from exactly these records.
        self.ownership_log: List[Tuple[int, str, float, Optional[float]]] = []

    # -- local reads (enqueue/dequeue filters, observability) ----------------

    def owned(self) -> FrozenSet[int]:
        with self._lock:
            return frozenset(self._owned)

    def draining(self) -> FrozenSet[int]:
        with self._lock:
            return frozenset(self._draining)

    def owns_shard(self, shard: int) -> bool:
        with self._lock:
            return shard in self._owned and shard not in self._draining

    def owns_key(self, namespace: str, name: str) -> bool:
        return self.owns_shard(shard_of(namespace, name, self.num_shards))

    def fence_token(self, shard: int) -> Optional[int]:
        with self._lock:
            return self._tokens.get(shard)

    def shard_map(self) -> Dict[int, dict]:
        """Last-observed holder per shard (the /debug/shards payload)."""
        with self._lock:
            out = {s: dict(info) for s, info in self._last_scan.items()}
            for s in range(self.num_shards):
                out.setdefault(s, {"holder": None})
                out[s]["owned_by_me"] = s in self._owned
            return out

    def add_listener(self, fn: ShardListener) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: ShardListener) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def add_drain_hook(self, fn: Callable[[int], bool]) -> None:
        with self._lock:
            self._drain_hooks.append(fn)

    def remove_drain_hook(self, fn: Callable[[int], bool]) -> None:
        with self._lock:
            if fn in self._drain_hooks:
                self._drain_hooks.remove(fn)

    def _quiet(self, shard: int) -> bool:
        """One non-blocking poll: every drain hook reports ``shard``
        quiet.  A hook that raises counts as quiet — a broken consumer
        must not wedge the rebalance forever."""
        with self._lock:
            hooks = list(self._drain_hooks)
        for hook in hooks:
            try:
                if not hook(shard):
                    return False
            except Exception:
                continue
        return True

    def _drain(self, shard: int, timeout: float) -> bool:
        """Blocking flavor for shutdown paths (never called from _tick —
        a blocked tick would stall renewals of every OTHER owned shard
        past their TTL)."""
        deadline = time.monotonic() + timeout
        while not self._quiet(shard):
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    # -- write-boundary fencing ----------------------------------------------

    def check_fence(self, namespace: str, name: str) -> int:
        """Prove this replica may write on behalf of key ``namespace/name``
        RIGHT NOW; returns the shard's fencing token.  Raises
        ``FencingError`` (and drops the shard) when it cannot:

        * shard not owned → another replica's key, never ours to write;
        * owned but STALE (last successful renew older than the lease
          duration — a paused/partitioned replica): one synchronous
          confirm-renew against the apiserver decides it.  Confirm
          succeeds → fresh again, write proceeds.  Confirm fails or shows
          another holder → the replica fences itself: the shard is
          dropped, listeners fire, the write never reaches the wire.
        """
        from kubeflow_tpu_torch.platform.runtime import metrics

        shard = shard_of(namespace, name, self.num_shards)
        with self._lock:
            if shard not in self._owned:
                raise FencingError(
                    f"shard {shard} (key {namespace}/{name}) is not owned "
                    f"by {self.identity}")
            renewed = self._renewed_at.get(shard)
            fresh = (renewed is not None
                     and time.monotonic() - renewed < self.lease_seconds)
            token = self._tokens.get(shard, 0)
        if fresh:
            return token
        # Stale: the lease we hold may have expired under us.  Confirm or
        # fence — NEVER write on a stale lease (the split-brain case).
        if self._confirm_renew(shard):
            return self.fence_token(shard) or token
        with self._lock:
            still = shard in self._owned
            self._owned.discard(shard)
            renewed = self._renewed_at.pop(shard, None)
            deadline = (renewed + self.lease_seconds
                        if renewed is not None else time.monotonic())
            self.ownership_log.append(
                (shard, "fenced", time.monotonic(), deadline))
        if still:
            metrics.controller_lease_transitions_total.labels(
                controller=self.name, reason="fenced").inc()
            log.warning(
                "%s: fenced self off shard %d (stale lease, confirm-renew "
                "failed) before writing %s/%s",
                self.identity, shard, namespace, name)
            self._fire(set(), {shard})
        raise FencingError(
            f"shard {shard} (key {namespace}/{name}) lease is stale and "
            f"could not be confirmed; {self.identity} fenced itself")

    def _confirm_renew(self, shard: int) -> bool:
        """One synchronous acquire-or-renew of ``shard``; True only when
        the lease is provably ours after the call."""
        try:
            return self._try_shard(shard) == "leading"
        except Exception:
            return False

    # -- lease plumbing ------------------------------------------------------

    def _shard_lease_name(self, shard: int) -> str:
        return f"{self.name}-shard-{shard}"

    def _member_lease_name(self) -> str:
        return f"{self.name}-member-{self.identity}"

    def _expired(self, lease: Optional[dict],
                 now: datetime.datetime) -> bool:
        if lease is None:
            return True
        holder = deep_get(lease, "spec", "holderIdentity")
        renew = _parse(deep_get(lease, "spec", "renewTime"))
        duration = deep_get(lease, "spec", "leaseDurationSeconds",
                            default=self.lease_seconds)
        return (not holder or renew is None
                or (now - renew).total_seconds() > float(duration))

    def _spec(self, now: datetime.datetime, *, transitions: int,
              acquire: Optional[str] = None) -> dict:
        # leaseDurationSeconds is int32 on a real apiserver; sub-second
        # TTLs (a chaos-test affordance — real deployments use >= 1 s)
        # ride as the float so the on-lease expiry other replicas compute
        # agrees with the local fencing clock instead of rounding up.
        duration = (self.lease_seconds if self.lease_seconds < 1.0
                    else int(self.lease_seconds))
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": duration,
            "acquireTime": acquire or _format(now),
            "renewTime": _format(now),
            "leaseTransitions": transitions,
        }

    def _try_shard(self, shard: int,
                   _tick_now: Optional[datetime.datetime] = None) -> str:
        """One acquire-or-renew round for one shard lease.  Returns
        "leading" | "lost" | "error" (leader.py semantics).  On "leading"
        the renewal clock and fencing token are updated.

        The wall timestamp written into the lease is taken HERE, paired
        with the monotonic ``t0`` — never a tick-start time reused across
        shards: under load a tick can spend seconds renewing earlier
        shards, and a stale ``renewTime`` would let a successor compute
        an expiry EARLIER than this owner's local ``t0 + lease_seconds``
        write deadline — an overlapping-ownership window (caught by the
        chaos suite's window assertion before this was fixed)."""
        lease_name = self._shard_lease_name(shard)
        t0 = time.monotonic()  # BEFORE the API calls: conservative clock
        now = self._now()      # wall twin of t0, stamped into the lease
        try:
            lease = self.client.get(LEASE, lease_name, self.namespace)
        except errors.NotFound:
            body = {
                "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                "metadata": {"name": lease_name,
                             "namespace": self.namespace},
                "spec": self._spec(now, transitions=0),
            }
            try:
                self.client.create(body)
            except Exception:
                return "error"  # creation race or API failure
            self._mark_renewed(shard, t0, 0)
            return "leading"
        except Exception:
            return "error"

        holder = deep_get(lease, "spec", "holderIdentity")
        if holder and holder != self.identity and not self._expired(
                lease, now):
            return "lost"
        transitions = deep_get(lease, "spec", "leaseTransitions", default=0)
        if holder != self.identity:
            transitions += 1  # ownership change: the fencing token bumps
        lease = dict(lease)
        lease["spec"] = self._spec(
            now, transitions=transitions,
            acquire=deep_get(lease, "spec", "acquireTime")
            if holder == self.identity else None,
        )
        try:
            self.client.update(lease)
        except Exception:
            return "error"  # conflict (another replica won) or API failure
        self._mark_renewed(shard, t0, transitions)
        return "leading"

    def _mark_renewed(self, shard: int, t0: float, token: int) -> None:
        with self._lock:
            self._renewed_at[shard] = t0
            self._tokens[shard] = token

    def _release_shard(self, shard: int) -> None:
        """Voluntarily free a shard lease (shed-to-joiner / shutdown):
        blank the holder so an acquirer does not wait out the TTL.
        Best-effort — an unreachable apiserver just means the lease
        expires on its own."""
        try:
            lease = self.client.get(
                LEASE, self._shard_lease_name(shard), self.namespace)
            if deep_get(lease, "spec", "holderIdentity") != self.identity:
                return
            lease = dict(lease)
            lease["spec"] = dict(lease["spec"])
            lease["spec"]["holderIdentity"] = ""
            lease["spec"]["renewTime"] = None
            self.client.update(lease)
        except Exception:
            log.debug("%s: shard %d lease release failed; it will expire "
                      "on its own", self.identity, shard, exc_info=True)

    def _renew_member(self, now: datetime.datetime) -> None:
        name = self._member_lease_name()
        try:
            lease = self.client.get(LEASE, name, self.namespace)
            lease = dict(lease)
            lease["spec"] = self._spec(now, transitions=0)
            self.client.update(lease)
        except errors.NotFound:
            try:
                self.client.create({
                    "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                    "metadata": {"name": name, "namespace": self.namespace},
                    "spec": self._spec(now, transitions=0),
                })
            except Exception:
                log.debug("%s: membership lease create failed; next renew "
                          "period retries", self.identity, exc_info=True)
        except Exception:
            log.debug("%s: membership lease renew failed; next renew "
                      "period retries", self.identity, exc_info=True)

    def _live_members(self, now: datetime.datetime) -> int:
        """Count distinct live membership leases (self included).  The
        fair share derives from this, so a joiner becomes visible to
        incumbents one renew period after it starts."""
        prefix = f"{self.name}-member-"
        members = 0
        try:
            for lease in self.client.list(LEASE, self.namespace):
                if not name_of(lease).startswith(prefix):
                    continue
                if not self._expired(lease, now):
                    members += 1
        except Exception:
            return 1  # can't see the roster: assume alone, don't shed
        return max(members, 1)

    # -- the coordination round ----------------------------------------------

    def _tick(self) -> None:
        from kubeflow_tpu_torch.platform.runtime import metrics

        now = self._now()
        self._renew_member(now)
        members = self._live_members(now)
        fair = math.ceil(self.num_shards / members)
        acquired: Set[int] = set()
        released: Set[int] = set()

        # 1. Renew what we own.  "lost" is definitive (a live foreign
        # holder — our lease expired and someone took it); "error" keeps
        # the shard but the renewal clock keeps aging, so writes fence
        # themselves once it crosses the TTL.
        scan: Dict[int, dict] = {}
        for shard in sorted(self.owned()):
            outcome = self._try_shard(shard)
            if outcome == "leading":
                metrics.controller_lease_transitions_total.labels(
                    controller=self.name, reason="renew").inc()
            elif outcome == "lost":
                with self._lock:
                    self._owned.discard(shard)
                    renewed = self._renewed_at.pop(shard, None)
                    self.ownership_log.append(
                        (shard, "renew-lost", time.monotonic(),
                         renewed + self.lease_seconds
                         if renewed is not None else time.monotonic()))
                released.add(shard)
                metrics.controller_lease_transitions_total.labels(
                    controller=self.name, reason="expire").inc()
                log.warning("%s: lost shard %d to another replica",
                            self.identity, shard)

        # 2. Acquire free/expired shards while under fair share.
        for shard in range(self.num_shards):
            if self.owns_shard(shard):
                continue
            try:
                lease = self.client.get(
                    LEASE, self._shard_lease_name(shard), self.namespace)
            except errors.NotFound:
                lease = None
            except Exception:
                continue
            if lease is not None:
                scan[shard] = {
                    "holder": deep_get(lease, "spec", "holderIdentity"),
                    "renewTime": deep_get(lease, "spec", "renewTime"),
                    "transitions": deep_get(
                        lease, "spec", "leaseTransitions", default=0),
                }
            with self._lock:
                have = len(self._owned)  # includes this tick's acquisitions
            if have >= fair:
                continue  # keep scanning for the shard-map view only
            if self._expired(lease, now):
                if self._try_shard(shard) == "leading":
                    with self._lock:
                        self._owned.add(shard)
                        self.ownership_log.append(
                            (shard, "acquire", time.monotonic(), None))
                    acquired.add(shard)
                    metrics.controller_lease_transitions_total.labels(
                        controller=self.name, reason="acquire").inc()
                    log.info("%s: acquired shard %d (members=%d fair=%d)",
                             self.identity, shard, members, fair)

        # 3. Shed excess to joiners: DRAIN-THEN-RELEASE, two-phase and
        # non-blocking.  This tick marks the highest-numbered excess
        # shards draining (new dequeues stop immediately — owns_key
        # answers False — while in-flight reconciles keep their write
        # rights: the lease is still ours); a shard is actually released
        # on the first tick its drain hooks report it quiet, so the
        # acquirer can never overlap a straggler's write (the
        # clean-handover half of the fencing invariant).  Non-blocking
        # on purpose: a blocking wait here would stall the renewals of
        # every OTHER owned shard past their TTL under load.
        with self._lock:
            while len(self._owned) - len(self._draining) > fair:
                shard = max(self._owned - self._draining)
                # New dequeues stop NOW (owns_key answers False for
                # draining shards — no listener needed for that); the
                # release EVENT waits for the actual release below, so
                # cache eviction never races the in-flight reconciles
                # the drain exists to protect.
                self._draining.add(shard)
                log.info("%s: draining shard %d to rebalance (members=%d "
                         "fair=%d)", self.identity, shard, members, fair)
            draining = sorted(self._draining & self._owned)
        for shard in draining:
            if not self._quiet(shard):
                continue  # next tick retries; the lease stays renewed
            with self._lock:
                self._owned.discard(shard)
                self._draining.discard(shard)
                self._renewed_at.pop(shard, None)
                t = time.monotonic()
                self.ownership_log.append((shard, "release", t, t))
            self._release_shard(shard)
            released.add(shard)
            metrics.controller_lease_transitions_total.labels(
                controller=self.name, reason="release").inc()
            log.info("%s: released shard %d", self.identity, shard)

        with self._lock:
            for shard, info in scan.items():
                self._last_scan[shard] = info
            for shard in self._owned:
                self._last_scan[shard] = {
                    "holder": self.identity,
                    "transitions": self._tokens.get(shard, 0),
                }
        if acquired or released:
            self._fire(acquired, released)

    def _fire(self, acquired: Set[int], released: Set[int]) -> None:
        with self._events_cond:
            self._epoch += 1
            epoch = self._epoch
        dispatcher = self._dispatch_thread
        if dispatcher is not None and dispatcher.is_alive():
            with self._events_cond:
                self._events.append((set(acquired), set(released), epoch))
                self._events_cond.notify()
            return
        self.current_event_epoch = epoch
        self._dispatch(acquired, released)

    def _dispatch(self, acquired: Set[int], released: Set[int]) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(set(acquired), set(released))
            except Exception:
                log.exception("%s: shard listener failed", self.identity)

    def _dispatch_loop(self) -> None:
        while True:
            with self._events_cond:
                while not self._events:
                    if self._stop.is_set():
                        return
                    self._events_cond.wait(0.2)
                acquired, released, epoch = self._events.pop(0)
            self.current_event_epoch = epoch
            self._dispatch(acquired, released)

    # -- lifecycle -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            delay = self.renew_seconds
            if not self._paused.is_set():
                try:
                    self._tick()
                except Exception:
                    # The loop must never die: a dead loop can neither
                    # renew (owned shards silently expire) nor acquire.
                    log.exception("%s: coordination round failed",
                                  self.identity)
                    delay = self.retry_seconds
            self._stop.wait(delay)

    def start(self) -> "ShardCoordinator":
        from kubeflow_tpu_torch.platform.runtime import metrics

        metrics.register_shard_coordinator(self)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop,
            name=f"shards-dispatch-{self.identity}", daemon=True)
        self._dispatch_thread.start()
        self._thread = threading.Thread(
            target=self._loop, name=f"shards-{self.identity}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Clean shutdown: stop the loop, release every owned shard lease
        and the membership lease so survivors rebalance immediately."""
        from kubeflow_tpu_torch.platform.runtime import metrics

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        released = set()
        with self._lock:
            owned = sorted(self._owned)
            # Draining first: new dequeues stop fleet-wide while
            # in-flight reconciles finish their (still-leased) writes.
            self._draining.update(owned)
        for shard in owned:
            self._drain(shard, self.lease_seconds)
        with self._lock:
            self._owned.clear()
            self._draining.clear()
            self._renewed_at.clear()
            t = time.monotonic()
            for shard in owned:
                self.ownership_log.append((shard, "release", t, t))
        for shard in owned:
            self._release_shard(shard)
            released.add(shard)
        try:
            self.client.delete(LEASE, self._member_lease_name(),
                               self.namespace)
        except Exception:
            log.debug("%s: membership lease delete on shutdown failed; "
                      "incumbents age it out", self.identity, exc_info=True)
        metrics.deregister_shard_coordinator(self)
        if released:
            # The dispatcher has usually exited by now (stop is set), so
            # this falls back to inline — a shutdown path may block.
            self._fire(set(), released)
        if self._dispatch_thread is not None:
            with self._events_cond:
                self._events_cond.notify()
            self._dispatch_thread.join(timeout=5)

    def crash(self) -> None:
        """The chaos kill: stop the loop WITHOUT releasing anything.  The
        owned shard leases (and the membership lease) age out over the
        lease TTL and survivors absorb the ranges — exactly what a
        SIGKILLed replica leaves behind."""
        from kubeflow_tpu_torch.platform.runtime import metrics

        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._dispatch_thread is not None:
            with self._events_cond:
                self._events_cond.notify()
            self._dispatch_thread.join(timeout=5)
        with self._lock:
            t = time.monotonic()
            for shard in sorted(self._owned):
                renewed = self._renewed_at.get(shard)
                self.ownership_log.append(
                    (shard, "crash", t,
                     renewed + self.lease_seconds
                     if renewed is not None else t))
        metrics.deregister_shard_coordinator(self)

    def pause(self) -> None:
        """Freeze renewals with everything else alive — the paused-but-
        alive replica of the split-brain test.  owns_key keeps answering
        True (the replica BELIEVES it owns its shards); check_fence is
        what stops it writing once the lease goes stale."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()


class FencedClient:
    """KubeClient wrapper enforcing lease fencing on the write path.

    Reads pass straight through.  A write performed on behalf of a
    reconcile (the controller sets the current request around
    ``reconcile()``; FlightPool carries it onto fan-out threads) must
    first prove shard ownership via ``coordinator.check_fence`` — a
    stale/foreign lease raises ``FencingError`` and the write NEVER
    reaches the inner client, which is the cross-process analogue of the
    workqueue's per-key exclusion.  Writes outside any reconcile (lease
    traffic goes through the raw client anyway; test fixtures) pass
    unfenced.

    With ``log_writes=True`` (the fleet harness), every write that
    reaches the server is recorded in ``write_log`` with its fence key,
    shard and token — the record ``ShardedFleet`` joins against the
    ChaosKube call logs and coordinator ownership windows to assert the
    no-overlapping-writes invariant.  A production controller leaves it
    OFF: an append-per-write list on a long-lived controller would
    grow RSS without bound for a log nothing reads.  ``fenced_total``
    counts either way.
    """

    def __init__(self, inner, coordinator: ShardCoordinator, *,
                 log_writes: bool = False):
        self.inner = inner
        self.coordinator = coordinator
        self._lock = threading.Lock()
        self.log_writes = log_writes
        # dicts: t, verb, kind, namespace, name, key, shard, token
        self.write_log: List[dict] = []
        self.fenced_total = 0

    def _fence(self) -> Optional[Tuple[Tuple[str, str], int, float]]:
        req = current_request()
        if req is None:
            return None
        try:
            token = self.coordinator.check_fence(req[0], req[1])
        except FencingError:
            with self._lock:
                self.fenced_total += 1
            raise
        # The AUTHORIZATION timestamp: the instant the fence held.  The
        # log records this (not the completion time) because it is what
        # the ownership-window invariant governs — the wire effect of an
        # authorized write may land epsilon later, which is why voluntary
        # handover drains in-flight reconciles before releasing.
        return req, token, time.monotonic()

    def _log_write(self, verb: str, kind: str, namespace: Optional[str],
                   name: str, ctx) -> None:
        if not self.log_writes:
            return
        entry = {
            "t": ctx[2] if ctx is not None else time.monotonic(),
            "verb": verb, "kind": kind,
            "namespace": namespace or "", "name": name,
        }
        if ctx is not None:
            (key_ns, key_name), token, _t = ctx
            entry["key"] = f"{key_ns}/{key_name}"
            entry["shard"] = shard_of(
                key_ns, key_name, self.coordinator.num_shards)
            entry["token"] = token
        with self._lock:
            self.write_log.append(entry)

    # -- fenced write verbs --------------------------------------------------

    def create(self, obj, *, dry_run: bool = False):
        gvk = gvk_of(obj)
        ctx = self._fence()
        out = self.inner.create(obj, dry_run=dry_run)
        self._log_write("create", gvk.kind, namespace_of(obj),
                        name_of(obj), ctx)
        return out

    def update(self, obj):
        gvk = gvk_of(obj)
        ctx = self._fence()
        out = self.inner.update(obj)
        self._log_write("update", gvk.kind, namespace_of(obj),
                        name_of(obj), ctx)
        return out

    def update_status(self, obj):
        gvk = gvk_of(obj)
        ctx = self._fence()
        # kft: disable=R004 client-shim pass-through, not a status author
        out = self.inner.update_status(obj)
        self._log_write("update_status", gvk.kind, namespace_of(obj),
                        name_of(obj), ctx)
        return out

    def patch(self, gvk, name, patch, namespace=None, *,
              patch_type: str = "merge"):
        ctx = self._fence()
        out = self.inner.patch(gvk, name, patch, namespace,
                               patch_type=patch_type)
        self._log_write("patch", gvk.kind, namespace, name, ctx)
        return out

    def patch_status(self, gvk, name, patch, namespace=None, *,
                     patch_type: str = "merge"):
        ctx = self._fence()
        out = self.inner.patch_status(gvk, name, patch, namespace,
                                      patch_type=patch_type)
        self._log_write("patch_status", gvk.kind, namespace, name, ctx)
        return out

    def delete(self, gvk, name, namespace=None, *,
               propagation: str = "Background"):
        ctx = self._fence()
        out = self.inner.delete(gvk, name, namespace,
                                propagation=propagation)
        self._log_write("delete", gvk.kind, namespace, name, ctx)
        return out

    # -- reads / everything else pass through --------------------------------

    def __getattr__(self, name):
        return getattr(self.inner, name)
