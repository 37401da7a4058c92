"""Telemetry of the port, standard library only: metrics, span traces, and
the serving and training series."""
