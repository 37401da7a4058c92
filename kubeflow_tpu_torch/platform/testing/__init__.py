from kubeflow_tpu_torch.platform.testing.fake import FakeKube

__all__ = ["FakeKube"]
