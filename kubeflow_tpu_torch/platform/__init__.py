"""The platform's GPU seams: the pieces a controller builds for a pod that
runs the port on NVIDIA GPUs.

Counterparts of the device-dependent parts of the reference's
``kubeflow_tpu/platform/``: the accelerator table and slice math
(``gpu/topology.py``), the pod pieces of a notebook, a job's worker and a
serving replica (``gpu/pods.py``), and the GPU quota (``k8s/quota.py``).
They are pure functions over dicts shaped like Kubernetes objects;
wiring them into the controllers is not part of the port.  Imports
nothing but the standard library and the port's ``parallel/envspec.py``.
"""
