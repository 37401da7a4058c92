"""Host-side data for the port's trainer: synthetic token streams, the
sequence packer, and a loader that moves each batch onto the device."""
from kubeflow_tpu_torch.data.loader import (  # noqa: F401
    DeviceLoader,
    synthetic_lm_batches,
    synthetic_lm_documents,
)
from kubeflow_tpu_torch.data.packing import (  # noqa: F401
    pack_documents,
    pack_tokens,
    packed_lm_batches,
)
