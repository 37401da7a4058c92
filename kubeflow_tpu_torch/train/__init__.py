"""Training of the port: LM and classification steps (``steps.py``), the
loop (``loop.py``), checkpoints (``checkpoint.py``), profiling
(``profiling.py``) and the CLI (``run.py``)."""
from kubeflow_tpu_torch.train.steps import (  # noqa: F401
    TrainState,
    adamw,
    chunked_cross_entropy,
    classification_loss,
    cross_entropy,
    make_classification_grad_fn,
    make_classification_train_step,
    make_grad_accum_step,
    make_lm_grad_fn,
    make_lm_train_step,
    sgd,
    token_nll,
)
