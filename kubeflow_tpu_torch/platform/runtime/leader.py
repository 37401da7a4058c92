"""Lease-based leader election for controller HA: the port's copy of
``kubeflow_tpu/platform/runtime/leader.py``.

A manager with leader election (controller-runtime's, reference
notebook-controller main.go:90-92) runs its controllers in exactly one
replica of a controller Deployment.  The contract, over a
``coordination.k8s.io/v1`` Lease: acquire it when it is free or expired,
renew it on a cadence, step down (and stop renewing) on release; an
optimistic-concurrency conflict means another replica won the race, and
the round is retried after the retry period.  A transient API error
demotes only once the lease last renewed has expired (client-go's
semantics).
"""
from __future__ import annotations

import copy
import datetime
import logging
import threading
import uuid
from typing import Callable, Optional

from kubeflow_tpu_torch.platform.k8s import errors
from kubeflow_tpu_torch.platform.k8s.types import LEASE, deep_get

log = logging.getLogger("kubeflow_tpu_torch.runtime.leader")

TIME_FORMAT = "%Y-%m-%dT%H:%M:%S.%fZ"


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


class LeaderElector:
    """Contend for a named Lease; run callbacks on gain/loss.

    ``on_started_leading`` fires (in the elector thread) when the lease is
    acquired; ``on_stopped_leading`` when it is lost or released.  Timings
    follow client-go defaults scaled down: lease_duration > renew_period.
    """

    def __init__(
        self,
        client,
        *,
        name: str,
        namespace: str = "kubeflow",
        identity: Optional[str] = None,
        lease_seconds: float = 15.0,
        renew_seconds: float = 5.0,
        retry_seconds: float = 2.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        now: Optional[Callable[[], datetime.datetime]] = None,
    ):
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{name}-{uuid.uuid4().hex[:8]}"
        self.lease_seconds = lease_seconds
        self.renew_seconds = renew_seconds
        self.retry_seconds = retry_seconds
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._now = now or (
            lambda: datetime.datetime.now(datetime.timezone.utc)
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.is_leader = False

    # -- single attempt ------------------------------------------------------

    def try_acquire_or_renew(self) -> str:
        """One election round.  Returns:

        * ``"leading"`` — we hold the lease after this round.
        * ``"lost"`` — another replica definitively holds a live lease.
        * ``"error"`` — transient failure (API error, conflict); leadership
          state is unknown.  Like client-go, the caller keeps acting as
          leader until the lease duration has elapsed without a successful
          renewal — a single apiserver blip must not cycle the leader.
        """
        now = self._now()
        try:
            lease = self.client.get(LEASE, self.name, self.namespace)
        except errors.NotFound:
            lease = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": self.name, "namespace": self.namespace},
                "spec": self._spec(now, transitions=0),
            }
            try:
                self.client.create(lease)
            except Exception:
                return "error"  # lost the creation race or API failure
            return "leading"
        except Exception:
            return "error"

        holder = deep_get(lease, "spec", "holderIdentity")
        renew = _parse(deep_get(lease, "spec", "renewTime"))
        duration = deep_get(
            lease, "spec", "leaseDurationSeconds", default=self.lease_seconds
        )
        expired = (
            renew is None
            or (now - renew).total_seconds() > float(duration)
        )
        if holder == self.identity:
            pass  # renew our own lease
        elif holder and not expired:
            return "lost"  # someone else holds a live lease
        transitions = deep_get(
            lease, "spec", "leaseTransitions", default=0
        ) + (0 if holder == self.identity else 1)
        lease = copy.deepcopy(lease)
        lease["spec"] = self._spec(
            now, transitions=transitions,
            acquire=deep_get(lease, "spec", "acquireTime")
            if holder == self.identity else None,
        )
        try:
            self.client.update(lease)
        except Exception:
            return "error"  # conflict or API failure; state unknown
        return "leading"

    def _spec(self, now, *, transitions: int, acquire: Optional[str] = None):
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_seconds),
            "acquireTime": acquire or _format(now),
            "renewTime": _format(now),
            "leaseTransitions": transitions,
        }

    def release(self) -> None:
        """Give the lease up so a standby can take over immediately.
        Best-effort: any failure (API or transport — shutdown often races
        an unreachable API server) must not abort the caller's shutdown;
        the lease then simply expires on its own."""
        try:
            lease = self.client.get(LEASE, self.name, self.namespace)
            if deep_get(lease, "spec", "holderIdentity") != self.identity:
                return
            lease = copy.deepcopy(lease)
            lease["spec"]["holderIdentity"] = ""
            lease["spec"]["renewTime"] = None
            self.client.update(lease)
        except Exception:
            log.debug("%s: leader lease release failed; it will expire on "
                      "its own", self.identity, exc_info=True)

    # -- loop ----------------------------------------------------------------

    def _loop(self) -> None:
        import time as _time

        last_renew = None  # monotonic time of the last successful renewal
        while not self._stop.is_set():
            try:
                outcome = self.try_acquire_or_renew()
            except Exception:
                # Belt and braces: the elector thread must never die — a
                # dead loop on a leader means it can't step down (split
                # brain) and on a standby means it never contends again.
                log.exception("%s: election round failed", self.name)
                outcome = "error"
            if outcome == "leading":
                last_renew = _time.monotonic()
                if not self.is_leader:
                    self.is_leader = True
                    log.info("%s: became leader (%s)", self.name, self.identity)
                    if self.on_started_leading:
                        self.on_started_leading()
            elif self.is_leader:
                # "lost" is definitive; "error" only demotes once the lease
                # we last renewed has fully expired (client-go semantics).
                expired = (
                    last_renew is None
                    or _time.monotonic() - last_renew > self.lease_seconds
                )
                if outcome == "lost" or expired:
                    self.is_leader = False
                    log.warning(
                        "%s: lost leadership (%s, %s)",
                        self.name, self.identity, outcome,
                    )
                    if self.on_stopped_leading:
                        self.on_stopped_leading()
            self._stop.wait(
                self.renew_seconds if outcome == "leading" else self.retry_seconds
            )

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"leader-{self.name}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self.is_leader:
            self.is_leader = False
            self.release()
            if self.on_stopped_leading:
                self.on_stopped_leading()
