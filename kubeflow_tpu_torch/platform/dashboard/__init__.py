"""The central dashboard's backend (``app.py``) and its utilization
series (``metrics_service.py``)."""
