"""Arithmetic / compression registry (counterpart: ``accl_tpu/ops/registry.py``).

Elementwise combine and the wire casts in plain torch; the Pallas plugin
lanes that register per-dtype kernels come with their slice (ROADMAP
queue 1, item 3). :func:`reduce_axis0` folds a ``(world, ...)`` stack in
ascending rank order, (((r0 ⊕ r1) ⊕ r2) ⊕ ...), the order the one-shot
and flat programs keep.
The int8 wire is the quantized extension: clip(round(x * scale), -127,
127) out, x / scale back (:func:`dequantize`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import dataType, reduceFunction, to_torch_dtype


def combine(a, b, fn: reduceFunction, dt: dataType):
    """Elementwise a ⊕ b (``dt`` keys the per-dtype plugin lanes of a later
    slice)."""
    if fn == reduceFunction.SUM:
        return a + b
    if fn == reduceFunction.MAX:
        return torch.maximum(a, b)
    raise ValueError(f"unsupported reduce function {fn}")


def reduce_axis0(x, fn: reduceFunction, dt: dataType):
    """Reduce a (world, ...) stack in ascending rank order."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = combine(acc, x[i], fn, dt)
    return acc


def dequantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x / scale`` for the int8 wire, computed as XLA compiles the JAX
    package's division by a constant: ``x`` times the float32 reciprocal of
    ``scale`` (one rounding of the product)."""
    inv = float(np.float32(1.0) / np.float32(scale))
    return x * inv


def quantize(x: torch.Tensor, scale: float, wdt=torch.int8) -> torch.Tensor:
    """clip(round(x * scale), -127, 127) in the wire dtype (round half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x * scale), -127, 127).to(wdt)


def compress(x, src: dataType, dst: dataType, scale=None):
    """Cast toward the wire dtype."""
    if src == dst:
        return x
    if dst == dataType.int8 and scale is not None:
        return quantize(x, scale)
    return x.to(to_torch_dtype(dst))


def decompress(x, src: dataType, dst: dataType, scale=None):
    """Cast back from the wire dtype."""
    if src == dataType.int8 and scale is not None:
        return dequantize(x.to(to_torch_dtype(dst)), scale)
    return compress(x, src, dst)
