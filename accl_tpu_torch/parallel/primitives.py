"""One-shot collective programs (counterpart: ``accl_tpu/parallel/primitives.py``).

These take the role XLA's native collectives play in the JAX package: the
counted baseline that AUTO selects below the ring kernels' thresholds.
Each program maps the ``(world, ...)`` tensor of all ranks to the result
of every rank with plain torch operations, folding in ascending rank
order (:func:`..ops.registry.reduce_axis0`). Wire compression
(``ETH_COMPRESSED``) casts to the wire dtype before the exchange and back
after it, as the JAX programs do; the fold runs in the wire dtype unless
the arith config decompresses first.
"""
from __future__ import annotations

from typing import Callable, Optional

from .. import ops
from ..arithconfig import ArithConfig
from ..communicator import Communicator
from ..constants import dataType, reduceFunction


def _wire(x, arith: Optional[ArithConfig]):
    """Cast to the wire dtype before a hop (compress lane)."""
    if arith is None or not arith.is_compressing:
        return x
    return ops.compress(x, arith.uncompressed, arith.compressed,
                        arith.quant_scale)


def _unwire(x, arith: Optional[ArithConfig], out_dtype):
    """Cast back after the hop (decompress lane)."""
    if arith is None or not arith.is_compressing:
        return x.to(out_dtype)
    return ops.decompress(x, arith.compressed, arith.uncompressed,
                          arith.quant_scale).to(out_dtype)


def _everyone(row, world: int):
    """Every rank holds ``row``: (n,) -> (world, n)."""
    return row.unsqueeze(0).expand(world, *row.shape).contiguous()


def build_allreduce(comm: Communicator, func: reduceFunction, dt: dataType,
                    arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n)."""
    world = comm.world_size

    def prog(send):
        x = _wire(send, arith)
        if arith is not None and arith.decompress_before_arith:
            g = ops.decompress(x, arith.compressed, arith.uncompressed,
                               arith.quant_scale)
            return _everyone(ops.reduce_axis0(g, func, dt).to(send.dtype),
                             world)
        red = ops.reduce_axis0(x, func, dt)
        return _everyone(_unwire(red, arith, send.dtype), world)

    return prog


def build_reduce_scatter(comm: Communicator, func: reduceFunction,
                         dt: dataType,
                         arith: Optional[ArithConfig] = None) -> Callable:
    """(world, world*n) -> (world, n): rank r gets the fold of every rank's
    chunk r."""
    world = comm.world_size

    def prog(send):
        x = _wire(send, arith)
        chunks = x.reshape(world, world, -1)   # [source rank, chunk]
        if func == reduceFunction.SUM and (
                arith is None or not arith.decompress_before_arith):
            return _unwire(ops.reduce_axis0(chunks, func, dt), arith,
                           send.dtype)
        if arith is not None and arith.is_compressing:
            chunks = ops.decompress(chunks, arith.compressed,
                                    arith.uncompressed, arith.quant_scale)
        return ops.reduce_axis0(chunks, func, dt).to(send.dtype)

    return prog


def build_allgather(comm: Communicator,
                    arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, world*n)."""
    world = comm.world_size

    def prog(send):
        g = _unwire(_wire(send, arith), arith, send.dtype)
        return _everyone(g.reshape(-1), world)

    return prog
