"""Collective programs (counterpart: ``accl_tpu/parallel/``)."""
