"""The platform's reconcilers in the port: the notebook's
(``notebook.py``)."""
