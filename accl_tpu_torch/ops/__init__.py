"""Arithmetic and compression plugins (counterpart: ``accl_tpu/ops/``)."""
from .registry import combine, compress, decompress, reduce_axis0  # noqa: F401
