"""The worker env contract: the variable names a controller injects into a
worker pod and ``parallel/dist.py`` reads back to join the process group.

The port's own copy of the constants and of ``worker_env_from`` in the
reference's ``kubeflow_tpu/parallel/envspec.py:22-113``, letter for
letter, so a pod spec written for the reference starts a port trainer.
Imports nothing but the standard library.
"""
from __future__ import annotations

from typing import Dict, Optional

# -- per-slice bootstrap (the GKE TPU-webhook contract) ----------------------
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_TOPOLOGY = "TPU_TOPOLOGY"
ENV_TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"
ENV_TPU_CHIPS_PER_HOST = "TPU_CHIPS_PER_HOST"
ENV_TPU_HOSTS_PER_SLICE = "TPU_HOSTS_PER_SLICE"

# -- cross-slice identity (GKE multislice) -----------------------------------
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_MEGASCALE_COORDINATOR_ADDRESS = "MEGASCALE_COORDINATOR_ADDRESS"

# -- platform -> trainer plumbing --------------------------------------------
# The checkpoint directory a job's gang resumes from (``train/run.py``'s
# ``--checkpoint-dir`` default).
ENV_KFT_CHECKPOINT_DIR = "KFT_CHECKPOINT_DIR"
# The job's declared slice count beside the granted one
# (MEGASCALE_NUM_SLICES), so a trainer can tell it runs shrunk
# (``dist.elastic_slices``).
ENV_KFT_SPEC_SLICES = "KFT_SPEC_SLICES"

# The rendezvous port the coordinator's Service exposes.
DEFAULT_COORDINATOR_PORT = 8476


def worker_env_from(environ: Dict[str, str]) -> Dict[str, Optional[str]]:
    """Parse the injected contract out of an environ mapping (the one
    discovery implementation; ``dist.worker_env`` binds it to
    ``os.environ``)."""
    return {
        "worker_id": environ.get(ENV_TPU_WORKER_ID),
        "hostnames": environ.get(ENV_TPU_WORKER_HOSTNAMES),
        "topology": environ.get(ENV_TPU_TOPOLOGY),
        "accelerator": environ.get(ENV_TPU_ACCELERATOR_TYPE),
        "hosts_per_slice": environ.get(ENV_TPU_HOSTS_PER_SLICE),
        "num_slices": environ.get(ENV_MEGASCALE_NUM_SLICES),
        "slice_id": environ.get(ENV_MEGASCALE_SLICE_ID),
        "coordinator": environ.get(ENV_MEGASCALE_COORDINATOR_ADDRESS),
        "spec_slices": environ.get(ENV_KFT_SPEC_SLICES),
    }
