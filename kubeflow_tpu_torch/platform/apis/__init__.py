"""The platform's API types in the port: the Notebook CRD with its
``spec.gpu`` block (``notebook.py``) and the PodDefault CRD with the GPU
PodDefault factory (``poddefault.py``)."""
