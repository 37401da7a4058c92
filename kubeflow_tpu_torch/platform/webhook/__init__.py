"""The PodDefault admission webhook in the port: the merge and the
AdmissionReview response (``mutate.py``) over the RFC 6902 JSON Patch
of ``jsonpatch.py``, served over HTTPS by ``server.py`` with the
serving pair of ``certs.py``."""
