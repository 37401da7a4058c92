"""Kubernetes helpers of the GPU seams: the quota math (``quota.py``)."""
