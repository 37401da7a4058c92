"""The controller runtime of the port's control plane: the reconciler's
contract (``controller.py``), child writes that carry the causal
context (``apply.py``), the event recorder (``events.py``), the bounded
fan-out (``flight.py``) and the metrics the notebook path writes
(``metrics.py``)."""
from kubeflow_tpu_torch.platform.runtime.controller import (
    Reconciler,
    Request,
    Result,
)
from kubeflow_tpu_torch.platform.runtime.events import (
    EventCorrelator,
    EventRecorder,
)
from kubeflow_tpu_torch.platform.runtime.flight import FlightPool

__all__ = ["Reconciler", "Request", "Result", "EventRecorder",
           "EventCorrelator", "FlightPool"]
