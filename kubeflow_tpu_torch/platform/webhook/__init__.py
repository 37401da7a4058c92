"""The PodDefault admission webhook in the port: the merge and the
AdmissionReview response (``mutate.py``) over the RFC 6902 JSON Patch
of ``jsonpatch.py``.  The TLS server waits for a later slice."""
