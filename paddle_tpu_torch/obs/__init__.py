"""Serving telemetry of the port: metrics registry and request tracer
(copies of paddle_tpu/obs/metrics.py and paddle_tpu/obs/tracing.py)."""
