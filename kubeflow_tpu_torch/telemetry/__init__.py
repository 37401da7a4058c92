"""Serving telemetry of the port: stdlib-only metrics and request traces."""
