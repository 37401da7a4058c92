"""The controller runtime of the port's control plane: the reconciler's
contract, the work queue, ``Controller`` and ``Manager``
(``controller.py``), leader election (``leader.py``), the informer
caches (``informer.py``), per-reconcile traces (``trace.py``), child
writes that carry the causal context (``apply.py``), the event recorder
(``events.py``), the bounded fan-out (``flight.py``), the job queue
(``jobqueue.py``) and the metrics (``metrics.py``)."""
from kubeflow_tpu_torch.platform.runtime.controller import (
    Controller,
    Manager,
    Reconciler,
    Request,
    Result,
)
from kubeflow_tpu_torch.platform.runtime.events import (
    EventCorrelator,
    EventRecorder,
)
from kubeflow_tpu_torch.platform.runtime.flight import FlightPool
from kubeflow_tpu_torch.platform.runtime.informer import Informer
from kubeflow_tpu_torch.platform.runtime.leader import LeaderElector

__all__ = ["Controller", "Manager", "Reconciler", "Request", "Result",
           "EventRecorder", "EventCorrelator", "FlightPool", "Informer",
           "LeaderElector"]
