"""One-shot collective programs (counterpart: ``accl_tpu/parallel/primitives.py``).

These take the role XLA's native collectives play in the JAX package: the
counted baseline that AUTO selects below the ring kernels' thresholds.
The local primitives ``copy`` and ``combine`` live here too, as there.
Each program maps the ``(world, ...)`` tensor of all ranks to the result
of every rank with plain torch operations, folding in ascending rank
order (:func:`..ops.registry.reduce_axis0`). Wire compression
(``ETH_COMPRESSED``) casts to the wire dtype before the exchange and back
after it, as the JAX programs do; the fold runs in the wire dtype unless
the arith config decompresses first. The rooted programs (bcast, scatter,
gather, reduce), the all-to-all and the barrier's zero-payload program are
here too; a gather or reduce program takes the receive buffer as its second
operand, writes the root's row of it in place and returns it: every other
row keeps its content, as the JAX programs' ``where(rank == root, ...,
recv)`` does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import constants, ops
from ..ops import reduce_ops
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


def _quantized(arith: Optional[ArithConfig]) -> bool:
    """The int8 wire with a scale (dequantized by a multiply)."""
    return (arith is not None and arith.is_compressing
            and arith.compressed == dataType.int8
            and arith.quant_scale is not None)


def _fold_in(acc, moved, func: reduceFunction, dt: dataType,
             arith: Optional[ArithConfig], moved_first: bool = False):
    """``combine(acc, unwire(moved))`` for a value ``moved`` that arrived in
    the wire dtype (``combine(unwire(moved), acc)`` with ``moved_first``,
    the ring reduce's operand order, which MAX's NaN and +-0 rules can
    see). A quantized SUM folds as XLA compiles it, one rounding
    (:func:`..ops.registry.add_dequantized`)."""
    if func == reduceFunction.SUM and _quantized(arith):
        return ops.registry.add_dequantized(acc, moved, arith.quant_scale)
    moved = _unwire(moved, arith, acc.dtype)
    if moved_first:
        return ops.combine(moved, acc, func, dt)
    return ops.combine(acc, moved, func, dt)


def _fold_wire(stack, func: reduceFunction, dt: dataType,
               arith: Optional[ArithConfig], out_dtype):
    """``reduce_axis0`` of a (world, ...) stack that arrived in the wire
    dtype, decompressed first (the decompress-before-arith fold)."""
    if func == reduceFunction.SUM and _quantized(arith):
        return ops.registry.reduce_dequantized(stack, arith.quant_scale,
                                               out_dtype)
    g = ops.decompress(stack, arith.compressed, arith.uncompressed,
                       arith.quant_scale)
    return ops.reduce_axis0(g, func, dt)


def _psum(stack, func: reduceFunction, dt: dataType):
    """``lax.psum`` / ``pmax`` of a (world, ...) stack as XLA on the CPU
    computes them: in rank order, a bfloat16 SUM accumulated in float32
    and rounded once (float16 sums round at every add)."""
    if func == reduceFunction.SUM and stack.dtype == torch.bfloat16:
        return ops.reduce_axis0(stack.float(), func, dt).to(torch.bfloat16)
    return ops.reduce_axis0(stack, func, dt)


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
            red = _fold_wire(x, func, dt, arith,
                             constants.to_torch_dtype(arith.uncompressed))
            return _everyone(red.to(send.dtype), world)
        red = _psum(x, func, dt)
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
            return _unwire(_psum(chunks, func, dt), arith, send.dtype)
        if arith is not None and arith.is_compressing:
            return _fold_wire(chunks, func, dt, arith,
                              constants.to_torch_dtype(
                                  arith.uncompressed)).to(send.dtype)
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


# --------------------------------------------------------------------------
# rooted collectives
# --------------------------------------------------------------------------

def _psum_of_root(row, world: int):
    """The JAX package's masked ``psum`` of the root's row, a new tensor:
    only the root contributes, every other rank adds zeros, so the sum is
    the row, except that -0.0 + +0.0 is +0.0."""
    return row + torch.zeros_like(row) if world > 1 else row.clone()


def build_bcast(comm: Communicator, root: int,
                arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n): every rank, the root too, gets the root's
    row through the wire (the JAX package's masked ``psum``)."""
    world = comm.world_size

    def prog(x):
        row = _psum_of_root(_wire(x[root], arith), world)
        return _everyone(_unwire(row, arith, x.dtype), world)

    return prog


def build_scatter(comm: Communicator, root: int,
                  arith: Optional[ArithConfig] = None) -> Callable:
    """(world, world*n) -> (world, n): rank r gets block r of the root's row,
    through the wire (the root's own block too)."""
    world = comm.world_size

    def prog(send):
        full = _psum_of_root(_wire(send[root], arith), world)
        return _unwire(full.view(world, -1), arith, send.dtype)

    return prog


def build_gather(comm: Communicator, root: int,
                 arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n), (world, world*n) -> (world, world*n): the root's row of
    ``recv`` gets every rank's block (its own too) through the wire."""

    def prog(send, recv):
        recv[root] = _unwire(_wire(send, arith), arith,
                             recv.dtype).reshape(-1)
        return recv

    return prog


def build_reduce(comm: Communicator, root: int, func: reduceFunction,
                 dt: dataType, arith: Optional[ArithConfig] = None
                 ) -> Callable:
    """(world, n), (world, n) -> (world, n): the root's row of ``recv`` gets
    the fold of every rank's row in rank order. A casting or quantized wire
    is decompressed before the fold (the JAX package gathers the wire
    payloads), else the fold runs in the wire dtype."""

    def prog(send, recv):
        x = _wire(send, arith)
        if arith is not None and arith.decompress_before_arith:
            red = _fold_wire(x, func, dt, arith,
                             constants.to_torch_dtype(arith.uncompressed))
        else:
            red = _unwire(_psum(x, func, dt), arith, recv.dtype)
        recv[root] = red
        return recv

    return prog


def build_alltoall(comm: Communicator,
                   arith: Optional[ArithConfig] = None) -> Callable:
    """(world, world*n) -> (world, world*n): chunk r of rank q lands at rank
    r, slot q. The whole send buffer goes through the wire, the rank's own
    chunk too (``lax.all_to_all`` of the wired buffer in the JAX
    package)."""
    world = comm.world_size

    def prog(send):
        x = _wire(send, arith).reshape(world, world, -1)
        swapped = torch.empty_like(x)
        swapped.copy_(x.transpose(0, 1))
        return _unwire(swapped.view(world, -1), arith, send.dtype)

    return prog


def build_barrier(comm: Communicator) -> Callable:
    """The zero-payload program: a (world,) token in, its sum out (the JAX
    package's scalar ``psum``)."""
    return lambda token: token.sum()


# --------------------------------------------------------------------------
# local primitives (no exchange)
# --------------------------------------------------------------------------

def build_copy(comm: Communicator) -> Callable:
    """``ACCL::copy``: every rank's local device copy. The JAX program's
    ``x + 0`` is a copy (XLA folds the add away; -0.0 stays -0.0)."""
    return lambda x: x.clone()


def build_combine(comm: Communicator, func: reduceFunction, dt: dataType,
                  use_pallas: bool = False, donate: bool = False) -> Callable:
    """``ACCL::combine``: every rank's elementwise reduce of two operands,
    ``prog(a, b)``. ``use_pallas`` routes the ``PALLAS_DTYPES`` through the
    plugin lane (:func:`..ops.reduce_ops.pallas_combine`, the CUDA combine
    kernel on the card), as the JAX package routes them through its Pallas
    lane; other dtypes and ``use_pallas=False`` take the registry's
    combine. ``donate`` writes the result into operand ``a``."""
    if use_pallas and dt in reduce_ops.PALLAS_DTYPES:
        return lambda a, b: reduce_ops.pallas_combine(
            a.contiguous(), b.contiguous(), func, donate=donate)

    return lambda a, b: ops.combine(a, b, func, dt)
