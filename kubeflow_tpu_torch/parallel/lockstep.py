"""Lock-step serving over a mesh: the control channel from global rank 0
to the other processes.

The reference serves under a mesh from ONE controller that drives every
chip, so it needs no such module.  The port runs one process a GPU, and
every process must run the same device work in the same order, or their
collectives pair up wrongly.  So rank 0 owns the HTTP app, the queue
and every decision that depends on the clock or on a request (admission
order, deadline expiry, whether a dispatched quantum is back yet,
stop), and broadcasts each decision before the device work it steers;
every other process runs a follower loop that applies the same
decisions to its own copy of the scheduler and takes none of its own.
A request is validated on rank 0 before anything about it is sent.

The channel is a gloo group on the host (``dist.new_group(backend=
"gloo")``), whatever backend the device work uses, so a decision never
synchronizes the card; it waits as long as a server idles.  An error on
any process ends the world: the process fails what it holds, tells its
peers when it can (``abort``) and exits, which closes its connections
and fails whatever collective a peer is waiting in; a peer stuck in a
device collective ends at the world's timeout.  Followers bind no port.
"""
from __future__ import annotations

import datetime
import logging
import threading
from typing import Any, Callable, Optional

import torch.distributed as dist

log = logging.getLogger("kubeflow_tpu_torch.lockstep")

# A follower waits for rank 0's next decision as long as the server is up.
CHANNEL_TIMEOUT = datetime.timedelta(days=7)


class WorldBroken(RuntimeError):
    """A process of the lock-step world failed: the world cannot serve."""


class Abort:
    """Rank 0's last message after a failure of its own: in place of any
    decision, it ends every follower."""

    def __init__(self, reason: str):
        self.reason = reason


class Lockstep:
    """Rank 0's decisions, broadcast to every process of the default group
    over a gloo group of their own.  Every process constructs it at the
    same point (``dist.new_group`` is collective).  With one process it
    exchanges nothing."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.group = (dist.new_group(backend="gloo", timeout=CHANNEL_TIMEOUT)
                      if self.world > 1 else None)
        self._lock = threading.Lock()
        self.broken: Optional[BaseException] = None

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def decide(self, fn: Optional[Callable[[], Any]] = None) -> Any:
        """On rank 0 ``fn()``, sent to every process; elsewhere the value
        rank 0 sent (``fn`` is not called).  Every process calls it at
        the same point of the same code."""
        if self.broken is not None:
            raise WorldBroken("the lock-step world is broken") \
                from self.broken
        value = fn() if self.leader else None
        if self.group is None:
            return value
        box = [value]
        try:
            with self._lock:
                dist.broadcast_object_list(box, src=0, group=self.group)
        except BaseException as exc:
            self.fail(exc)
            raise
        if isinstance(box[0], Abort):
            exc = WorldBroken(f"rank 0 aborted the world: {box[0].reason}")
            self.fail(exc)
            raise exc
        return box[0]

    def send(self, message) -> None:
        """Rank 0: one message to the followers' loop."""
        self.decide(lambda: message)

    def recv(self):
        """A follower: rank 0's next message."""
        return self.decide()

    def fail(self, exc: BaseException) -> None:
        """Mark the world broken: every later decision raises."""
        if self.broken is None:
            self.broken = exc
            log.error("lock-step world broken on rank %d: %r", self.rank, exc)

    def abort(self, exc: BaseException) -> None:
        """After a failure of this process's own: mark the world broken
        and, on rank 0, tell the followers, waiting at most a second for
        the send: it takes milliseconds to a follower waiting for a
        decision and fails at once where a peer is gone, while a follower
        held in a device collective takes it only once that collective
        ends (one that never does ends when rank 0's process exits).  A
        follower only marks it: its exit closes the connections rank 0
        waits on."""
        tell = self.leader and self.broken is None and self.group is not None
        self.fail(exc)
        if tell:
            sender = threading.Thread(
                target=self._send_quietly, args=([Abort(repr(exc))],),
                daemon=True, name="kft-lockstep-abort")
            sender.start()
            sender.join(timeout=1.0)

    def _send_quietly(self, box) -> None:
        try:
            with self._lock:
                dist.broadcast_object_list(box, src=0, group=self.group)
        except Exception:  # noqa: BLE001 — the peers may be gone already
            pass

