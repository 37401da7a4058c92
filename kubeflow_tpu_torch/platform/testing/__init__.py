from kubeflow_tpu_torch.platform.testing.chaos import ChaosKube, Fault
from kubeflow_tpu_torch.platform.testing.fake import FakeKube
from kubeflow_tpu_torch.platform.testing.shardfleet import ShardedFleet

__all__ = ["ChaosKube", "FakeKube", "Fault", "ShardedFleet"]
