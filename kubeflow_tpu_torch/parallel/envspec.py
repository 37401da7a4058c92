"""The worker env contract: the variable names a controller injects into a
worker pod and ``parallel/dist.py`` reads back to join the process group.

The port's own copy of the constants, of the three blocks a controller
injects (``tpu_bootstrap_env``, ``megascale_env``, ``elastic_env``) and of
``worker_env_from`` in the reference's
``kubeflow_tpu/parallel/envspec.py:22-113``, letter for letter, so a pod
spec written for the reference starts a port trainer.  A GPU pod carries
``gpu_bootstrap_env`` in place of the TPU block: the host identity
``dist`` reads and ``KFT_GPUS_PER_HOST``, the processes
``parallel/launch.py`` starts on the host.  Imports nothing but the
standard library.
"""
from __future__ import annotations

from typing import Dict, List, Optional

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
# The GPUs of one host of a GPU pod: ``parallel/launch.py`` starts one
# process for each.
ENV_KFT_GPUS_PER_HOST = "KFT_GPUS_PER_HOST"

# The rendezvous port the coordinator's Service exposes.
DEFAULT_COORDINATOR_PORT = 8476

# StatefulSet pods carry their ordinal in this label; the downward-API
# fieldRef below turns it into TPU_WORKER_ID.
_POD_INDEX_FIELD = "metadata.labels['apps.kubernetes.io/pod-index']"


def tpu_bootstrap_env(*, topology: str, accelerator: str, chips: int,
                      chips_per_host: int, num_hosts: int,
                      hostnames: str) -> List[dict]:
    """The per-slice TPU bootstrap block a controller injects into every
    worker of one slice (k8s EnvVar-shaped dicts, values as
    ``worker_env_from`` reads them back)."""
    return [
        {"name": ENV_TPU_WORKER_ID, "valueFrom": {"fieldRef": {
            "fieldPath": _POD_INDEX_FIELD}}},
        {"name": ENV_TPU_WORKER_HOSTNAMES, "value": hostnames},
        {"name": ENV_TPU_TOPOLOGY, "value": topology},
        {"name": ENV_TPU_ACCELERATOR_TYPE,
         "value": f"{accelerator}-{chips}"},
        {"name": ENV_TPU_CHIPS_PER_HOST, "value": str(chips_per_host)},
        {"name": ENV_TPU_HOSTS_PER_SLICE, "value": str(num_hosts)},
    ]


def gpu_bootstrap_env(*, gpus_per_host: int, num_hosts: int,
                      hostnames: str) -> List[dict]:
    """The per-slice block of a GPU pod: ``tpu_bootstrap_env`` without the
    three names only libtpu reads (``TPU_TOPOLOGY``,
    ``TPU_ACCELERATOR_TYPE``, ``TPU_CHIPS_PER_HOST``), with
    ``KFT_GPUS_PER_HOST`` where the chips a host stood.  The host's
    identity (its ordinal, the slice's hostnames) is what
    ``dist.process_grid`` turns into the launcher's node rank."""
    return [
        {"name": ENV_TPU_WORKER_ID, "valueFrom": {"fieldRef": {
            "fieldPath": _POD_INDEX_FIELD}}},
        {"name": ENV_TPU_WORKER_HOSTNAMES, "value": hostnames},
        {"name": ENV_KFT_GPUS_PER_HOST, "value": str(gpus_per_host)},
        {"name": ENV_TPU_HOSTS_PER_SLICE, "value": str(num_hosts)},
    ]


def megascale_env(slice_id: int, num_slices: int,
                  coordinator_address: str) -> List[dict]:
    """The cross-slice block a controller injects into every worker of
    slice ``slice_id``."""
    return [
        {"name": ENV_MEGASCALE_SLICE_ID, "value": str(slice_id)},
        {"name": ENV_MEGASCALE_NUM_SLICES, "value": str(num_slices)},
        {"name": ENV_MEGASCALE_COORDINATOR_ADDRESS,
         "value": coordinator_address},
    ]


def elastic_env(spec_slices: int) -> List[dict]:
    """The elastic-capacity marker beside the MEGASCALE block: the job's
    declared width (the granted one is MEGASCALE_NUM_SLICES)."""
    return [{"name": ENV_KFT_SPEC_SLICES, "value": str(spec_slices)}]


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
