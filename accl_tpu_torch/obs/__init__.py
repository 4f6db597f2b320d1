"""Observability (counterpart: ``accl_tpu/obs/``): the metrics registry
core only; tracing, the flight recorder and exporters come later."""
