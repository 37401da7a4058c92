"""The reconciler's contract: the port's copy of ``Request``, ``Result``
and ``Reconciler`` of ``kubeflow_tpu/platform/runtime/controller.py``.

A reconciler runs bare on a client: ``reconcile(Request(ns, name))``
reads the primary object and converges its children.  The work queue,
``Controller`` and ``Manager`` that drive it from watches are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True, order=True)
class Request:
    namespace: str
    name: str


@dataclasses.dataclass
class Result:
    requeue_after: Optional[float] = None  # seconds


class Reconciler:
    """Subclass and implement reconcile().  Raise to trigger backoff requeue."""

    def reconcile(self, req: Request) -> Optional[Result]:  # pragma: no cover
        raise NotImplementedError
