"""Arithmetic / compression registry (counterpart: ``accl_tpu/ops/registry.py``).

Maps ``(function, dtype)`` to an elementwise combine callable and ``(src
dtype, dst dtype)`` to a cast callable, with the same lookup as the JAX
package: a registered plugin lane first, else plain torch. The tables start
empty, as in the JAX package, where nothing registers a lane: the plugin
kernels of :mod:`.reduce_ops` and :mod:`.compression` are reached
explicitly (``ACCL.combine``, the two-tier DCN wire), and
:func:`register_combine` / :func:`register_cast` let a caller route the
registry through them. :func:`reduce_axis0` folds a ``(world, ...)`` stack
in ascending rank order, (((r0 ⊕ r1) ⊕ r2) ⊕ ...), the order the one-shot
and flat programs keep.

MAX is IEEE-754 ``maximum``, as ``jnp.maximum`` is: NaN propagates and
+0 > -0 (:func:`maximum`; ``torch.maximum`` alone returns its first operand
when the two compare equal, so it would keep -0 against +0).

The int8 wire is the quantized extension: clip(round(x * scale), -127,
127) out, x / scale back (:func:`dequantize`).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..constants import dataType, reduceFunction, to_torch_dtype

# (function, dataType) -> combine(a, b) -> a ⊕ b
_COMBINE_REGISTRY: Dict[Tuple[reduceFunction, dataType], Callable] = {}
# (src dataType, dst dataType) -> cast(x) -> x in dst
_CAST_REGISTRY: Dict[Tuple[dataType, dataType], Callable] = {}


def register_combine(fn: reduceFunction, dt: dataType, impl: Callable) -> None:
    _COMBINE_REGISTRY[(fn, dt)] = impl


def register_cast(src: dataType, dst: dataType, impl: Callable) -> None:
    _CAST_REGISTRY[(src, dst)] = impl


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE-754 ``maximum`` (``jnp.maximum``): a NaN operand propagates and
    +0 > -0. When both are NaN, ``jnp.maximum`` on the CPU returns ``a`` if
    its sign bit is set, else ``b`` (so the operand order of a fold shows in
    the NaN bits)."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    nan_a = torch.isnan(a)
    take_b = torch.isnan(b) & (~nan_a | ~torch.signbit(a))
    take_b |= b > a
    take_b |= (a == b) & torch.signbit(a) & ~torch.signbit(b)
    return torch.where(take_b, b, a)


def combine(a, b, fn: reduceFunction, dt: dataType):
    """Elementwise a ⊕ b (reduce_ops plugin analog)."""
    impl = _COMBINE_REGISTRY.get((fn, dt))
    if impl is not None:
        return impl(a, b)
    if fn == reduceFunction.SUM:
        return a + b
    if fn == reduceFunction.MAX:
        return maximum(a, b)
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


def add_dequantized(acc: torch.Tensor, q: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``acc + dequantize(q, scale)`` as XLA on the CPU compiles it when the
    two share a fusion: the reciprocal multiply contracts into a fused
    multiply-add, so the sum rounds once. Emulated in float64, where the
    product of an int8 and a float32 is exact (the float64 sum is exact
    too unless the two terms differ in magnitude by more than 2**21)."""
    inv = float(np.float32(1.0) / np.float32(scale))
    return (q.to(torch.float64) * inv + acc.to(torch.float64)).to(acc.dtype)


def reduce_dequantized(q: torch.Tensor, scale: float,
                       out_dtype=torch.float32) -> torch.Tensor:
    """SUM of ``dequantize(q[i])`` over axis 0 in rank order, as XLA on the
    CPU compiles the JAX package's fold: the first add contracts rank 0's
    product into a fused multiply-add with rank 1's rounded product, every
    later add contracts its rank's product."""
    if q.shape[0] == 1:
        return dequantize(q[0].to(out_dtype), scale)
    acc = add_dequantized(dequantize(q[1].to(out_dtype), scale), q[0], scale)
    for i in range(2, q.shape[0]):
        acc = add_dequantized(acc, q[i], scale)
    return acc


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
    impl = _CAST_REGISTRY.get((src, dst))
    if impl is not None:
        return impl(x)
    return x.to(to_torch_dtype(dst))


def decompress(x, src: dataType, dst: dataType, scale=None):
    """Cast back from the wire dtype."""
    if src == dataType.int8 and scale is not None:
        return dequantize(x.to(to_torch_dtype(dst)), scale)
    return compress(x, src, dst)
