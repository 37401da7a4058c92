"""Training of the port: LM steps (``steps.py``), the loop (``loop.py``)
and the CLI (``run.py``)."""
from kubeflow_tpu_torch.train.steps import (  # noqa: F401
    TrainState,
    adamw,
    chunked_cross_entropy,
    cross_entropy,
    make_grad_accum_step,
    make_lm_grad_fn,
    make_lm_train_step,
    token_nll,
)
