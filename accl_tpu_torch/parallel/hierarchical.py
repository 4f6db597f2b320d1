"""Hierarchical 2-D and two-tier collectives (counterpart:
``accl_tpu/parallel/hierarchical.py``).

Rank r sits at (r // cols, r % cols) of a (rows, cols) grid, raster order.
The JAX package runs each phase as an XLA collective over one named axis
of a 2-D mesh; here the ranks are rows of one ``(world, n)`` tensor, so a
phase is a reshape of that tensor to ``(rows, cols, ...)`` and a fold over
one grid axis.

* :func:`build_hier_allreduce`: reduce-scatter within each grid row,
  all-reduce of the shard across rows, all-gather within each row.
  :func:`build_hier_reduce_bcast`: reduce to the row leaders, across the
  leaders, and back. Where the JAX package folds explicitly
  (``reduce_axis0``, the decompress-before-arith branch) the fold order is
  the same here and results are bit-equal; its ``psum``/``pmax`` branches
  fold in the XLA runtime's order, which this port replaces by ascending
  rank order, so those agree exactly where the fold is exact (e.g.
  integer-valued operands).
* ``build_twotier_*``: the multi-slice schedules, rows = slices (the DCN
  boundary), columns = the devices of a slice. Only the shard-sized
  cross-slice leg compresses, in the ``dcn_wire_dtype`` codec: ``"bf16"``
  through :func:`..ops.compression.pallas_cast`, ``"bf16_sr"`` through
  :func:`..ops.compression.pallas_compress_stochastic` with per-leg seeds
  from :func:`..ops.compression.derive_seed`; on the card both are the
  plugin kernels of ``csrc/plugins.cu``. Each rank's payload compresses
  with its own seed, derived from that payload's bits, as each rank of the
  JAX program does; the port hands the kernel one seed per rank row.

Plain torch around the plugin kernels, as the JAX package's XLA
collectives are.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import ops
from ..ops import compression
from ..arithconfig import ArithConfig
from ..communicator import Communicator
from ..constants import dataType, reduceFunction
from .primitives import _unwire, _wire

#: DCN cross-slice wire codecs (``ACCLConfig.dcn_wire_dtype`` values)
DCN_WIRE_DTYPES = ("off", "bf16", "bf16_sr")

#: session default for the cross-slice wire dtype (config write-through);
#: per-build override via the ``dcn_wire_dtype`` argument of every
#: two-tier builder
_DCN_WIRE_DEFAULT = "off"


def set_dcn_wire_dtype(name: Optional[str]) -> None:
    """Config write-through for ``ACCLConfig.dcn_wire_dtype``: the session
    default the two-tier builders resolve when a build passes none.
    ``None`` means "off"."""
    global _DCN_WIRE_DEFAULT
    name = name or "off"
    if name not in DCN_WIRE_DTYPES:
        raise ValueError(
            f"unsupported dcn_wire_dtype {name!r}; one of "
            f"{list(DCN_WIRE_DTYPES)}")
    _DCN_WIRE_DEFAULT = name


def get_dcn_wire_dtype() -> str:
    return _DCN_WIRE_DEFAULT


def _resolve_dcn_wire(dcn_wire_dtype: Optional[str],
                      arith: Optional[ArithConfig]) -> str:
    """The cross-slice codec of one build: the explicit argument, else the
    session register. A compressing call-level ArithConfig already narrows
    every hop, so the DCN codec stands down ("off") under it rather than
    round twice."""
    name = dcn_wire_dtype if dcn_wire_dtype is not None \
        else _DCN_WIRE_DEFAULT
    if name not in DCN_WIRE_DTYPES:
        raise ValueError(
            f"unsupported dcn_wire_dtype {name!r}; one of "
            f"{list(DCN_WIRE_DTYPES)}")
    if arith is not None and arith.is_compressing:
        return "off"
    return name


def _dcn_compress(x: torch.Tensor, wire: str, step: int) -> torch.Tensor:
    """Stage the cross-slice payloads, one rank per row of ``x`` (ranks,
    m), into the DCN wire dtype; identity at "off" and for operands at or
    below the wire's width. ``step`` indexes the schedule leg, so two
    compressed legs never round with the same pattern.

    float32 rides the plugin lanes. float64 has no lane in ``CAST_PAIRS``
    (the TPU has no f64), so it takes the plain cast, as it does in the
    JAX package off the TPU."""
    if wire == "off":
        return x
    if x.element_size() <= 2 or not x.is_floating_point():
        return x
    if x.dtype != torch.float32:
        return x.to(torch.bfloat16)
    if wire == "bf16_sr":
        seed = compression.derive_seed(compression.payload_seed_base(x),
                                       step)
        return compression.pallas_compress_stochastic(
            x.contiguous(), torch.bfloat16, seed=seed)
    return compression.pallas_cast(x.contiguous(), torch.bfloat16)


def _dcn_decompress(x: torch.Tensor, out_dtype) -> torch.Tensor:
    """Widen a cross-slice payload before any fold (exact)."""
    return x.to(out_dtype)


#: payload dtypes the cross-slice codec can narrow
DCN_COMPRESSIBLE = (dataType.float32, dataType.float64)


def dcn_wire_inert(dtype: dataType, arith: Optional[ArithConfig]) -> bool:
    """True when the DCN codec cannot compress a call: a compressing
    ArithConfig already narrows every hop, or the dtype is outside
    :data:`DCN_COMPRESSIBLE`."""
    if arith is not None and arith.is_compressing:
        return True
    return dtype not in DCN_COMPRESSIBLE


def factor2d(world: int) -> Optional[Tuple[int, int]]:
    """Most-square (rows, cols) factorization, None if world is prime/1."""
    best = None
    for rows in range(2, int(world ** 0.5) + 1):
        if world % rows == 0:
            best = (rows, world // rows)
    return best


def _pad(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % mult
    if not pad:
        return x
    out = torch.zeros((x.shape[0], x.shape[-1] + pad), dtype=x.dtype,
                      device=x.device)
    out[:, :x.shape[-1]] = x
    return out


def _fold(x: torch.Tensor, dim: int, func, dt) -> torch.Tensor:
    """Fold ``x`` over ``dim`` in ascending order."""
    return ops.reduce_axis0(x.movedim(dim, 0), func, dt)


def _everyone(row: torch.Tensor, world: int) -> torch.Tensor:
    return row.reshape(1, -1).expand(world, -1).contiguous()


def build_hier_allreduce(comm: Communicator, rows: int, cols: int,
                         func: reduceFunction, dt: dataType,
                         arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n): 2-D reduce-scatter / cross-row all-reduce /
    all-gather (bandwidth variant)."""
    world = comm.world_size
    if rows * cols != world:
        raise ValueError(f"{rows}x{cols} != world {world}")
    decompress_arith = arith is not None and arith.decompress_before_arith

    def prog(v):
        n = v.shape[-1]
        x = _pad(v, cols)
        m = x.shape[-1] // cols
        w = _wire(x, arith).reshape(rows, cols, cols, m)   # [i, k, chunk j]
        if func == reduceFunction.SUM and decompress_arith:
            # chunk exchange along the row and a full-precision fold, then
            # the cross-row fold of the shard, every hop in the wire dtype
            shard = _fold(_unwire(w, arith, x.dtype), 1, func, dt)  # [i, j]
            g = _wire(shard, arith)
            shard = _fold(_unwire(g, arith, x.dtype), 0, func, dt)  # [j]
            full = _unwire(_wire(shard, arith), arith, v.dtype)
        elif func == reduceFunction.SUM:
            # psum_scatter along the row, psum across rows, all_gather
            shard = _fold(w, 1, func, dt)
            full = _unwire(_fold(shard, 0, func, dt), arith, v.dtype)
        elif func == reduceFunction.MAX:
            # max of wire values == wire of max (monotone cast)
            full = _unwire(_fold(w.reshape(world, -1), 0, func, dt), arith,
                           v.dtype)
        else:
            raise ValueError(func)
        return _everyone(full, world)[:, :n]

    return prog


def build_hier_reduce_bcast(comm: Communicator, rows: int, cols: int,
                            func: reduceFunction, dt: dataType,
                            arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n): reduce within rows to the row leader
    (column 0), across the leaders, and broadcast back (latency
    variant)."""
    world = comm.world_size
    if rows * cols != world:
        raise ValueError(f"{rows}x{cols} != world {world}")
    decompress_arith = arith is not None and arith.decompress_before_arith

    def prog(v):
        w = _wire(v, arith).reshape(rows, cols, -1)
        if func == reduceFunction.SUM and decompress_arith:
            row_tot = _fold(_unwire(w, arith, v.dtype), 1, func, dt)
            g2 = _wire(row_tot, arith)
            total = _fold(_unwire(g2, arith, v.dtype), 0, func, dt)
            return _everyone(total.to(v.dtype), world)
        if func == reduceFunction.SUM:
            row_tot = _fold(w, 1, func, dt)
            tot = _fold(row_tot, 0, func, dt)
            if cols > 1:
                # the leader column's total meets the other columns'
                # zeros in the row psum that broadcasts it
                tot = tot + torch.zeros_like(tot)
            total = tot
        elif func == reduceFunction.MAX:
            total = _fold(w.reshape(world, -1), 0, func, dt)
        else:
            raise ValueError(func)
        return _everyone(_unwire(total, arith, v.dtype), world)

    return prog


# ---------------------------------------------------------------------------
# two-tier DCN schedules: intra-slice legs at full precision, one
# cross-slice exchange in the dcn_wire_dtype codec
# ---------------------------------------------------------------------------

def _check_twotier(comm: Communicator, slices: int, per_slice: int) -> None:
    if slices * per_slice != comm.world_size:
        raise ValueError(
            f"{slices}x{per_slice} != world {comm.world_size}")
    if slices < 2 or per_slice < 2:
        raise ValueError(
            f"two-tier schedules need >=2 slices of >=2 devices, got "
            f"{slices}x{per_slice}")


def _intra_slice_rs(t: torch.Tensor, func, dt, arith, compressing: bool,
                    dtype) -> torch.Tensor:
    """Leg 1: t [slice i, member k, chunk j, ...] -> the fold over k, rank
    (i, j)'s shard: a psum_scatter (SUM, uncompressed) or a chunk exchange
    with a full-precision fold."""
    if func == reduceFunction.SUM and not compressing:
        return _fold(t, 1, func, dt)
    return _fold(_unwire(_wire(t, arith), arith, dtype), 1, func, dt)


def build_twotier_allreduce(comm: Communicator, slices: int, per_slice: int,
                            func: reduceFunction, dt: dataType,
                            arith: Optional[ArithConfig] = None,
                            dcn_wire_dtype: Optional[str] = None
                            ) -> Callable:
    """(world, n) -> (world, n): intra-slice reduce-scatter (full
    precision) -> the shard gathered across slices in the cross-slice
    wire dtype and folded at full precision after widening -> intra-slice
    all-gather. Bit-exact at "off" where the leg-1 psum is exact."""
    _check_twotier(comm, slices, per_slice)
    wire = _resolve_dcn_wire(dcn_wire_dtype, arith)
    compressing = arith is not None and arith.is_compressing
    S, L = slices, per_slice
    world = S * L

    def prog(v):
        n = v.shape[-1]
        x = _pad(v, world)
        m = x.shape[-1] // L
        shard = _intra_slice_rs(x.reshape(S, L, L, m), func, dt, arith,
                                compressing, x.dtype)       # [i, j]
        if compressing:
            g = _wire(shard, arith)
            shard = _fold(_unwire(g, arith, x.dtype), 0, func, dt)
        else:
            g = _dcn_compress(shard.reshape(world, m), wire, step=1)
            shard = _fold(_dcn_decompress(g, x.dtype).reshape(S, L, m), 0,
                          func, dt)                          # [j]
        full = _unwire(_wire(shard, arith), arith, v.dtype)
        return _everyone(full, world)[:, :n]

    return prog


def build_twotier_reduce_scatter(comm: Communicator, slices: int,
                                 per_slice: int, func: reduceFunction,
                                 dt: dataType,
                                 arith: Optional[ArithConfig] = None,
                                 dcn_wire_dtype: Optional[str] = None
                                 ) -> Callable:
    """(world, world*count) -> (world, count): the intra-slice
    reduce-scatter lands rank (i, j) the partials of chunks (., j); the
    cross-slice all-to-all (wire-staged) delivers chunk i*L+j's per-slice
    partials for the full-precision fold, so rank r ends with chunk r."""
    _check_twotier(comm, slices, per_slice)
    wire = _resolve_dcn_wire(dcn_wire_dtype, arith)
    compressing = arith is not None and arith.is_compressing
    S, L = slices, per_slice
    world = S * L

    def prog(v):
        count = v.shape[-1] // world
        # rank (i, k)'s row of chunk (s, j) -> t[i, k, j, s]
        t = v.reshape(S, L, S, L, count).permute(0, 1, 3, 2, 4)
        shard = _intra_slice_rs(t, func, dt, arith, compressing,
                                v.dtype)                    # [i', j, s]
        if compressing:
            g = _unwire(_wire(shard, arith), arith, v.dtype)
        else:
            g = _dcn_compress(shard.reshape(world, S * count), wire, step=1)
            g = _dcn_decompress(g, v.dtype).reshape(S, L, S, count)
        # rank (i, j) folds slice i's chunk over the sending slices i'
        out = _fold(g, 0, func, dt).permute(1, 0, 2)        # [i, j]
        return out.reshape(world, count).to(v.dtype)

    return prog


def build_twotier_allgather(comm: Communicator, slices: int, per_slice: int,
                            arith: Optional[ArithConfig] = None,
                            dcn_wire_dtype: Optional[str] = None
                            ) -> Callable:
    """(world, count) -> (world, world*count): the own block crosses the DCN
    once in the wire dtype, then the intra-slice all-gather replicates the
    widened stack at full precision, in flat rank order."""
    _check_twotier(comm, slices, per_slice)
    wire = _resolve_dcn_wire(dcn_wire_dtype, arith)
    compressing = arith is not None and arith.is_compressing
    world = slices * per_slice

    def prog(v):
        if compressing:
            g = _unwire(_wire(v, arith), arith, v.dtype)
        else:
            g = _dcn_decompress(_dcn_compress(v, wire, step=0), v.dtype)
        g = _unwire(_wire(g, arith), arith, v.dtype)
        return _everyone(g, world)

    return prog
