"""Runtime algorithm selection and builder dispatch (counterpart:
``accl_tpu/parallel/algorithms.py``).

:func:`select` resolves the algorithm family for one call from (operation,
payload bytes, world, config) with the JAX package's scalar-threshold
ladder (``_select_legacy``, verbatim) and its decline counters. On the
intra-node tier (``TransportBackend.ICI``, the card) allreduce takes the
ring kernels (``Algorithm.PALLAS``) from ``pallas_threshold`` up.

The JAX package then hands the ladder's decision to the schedule
synthesizer (``accl_tpu/parallel/synth.py:resolve``). Of it this port
keeps the one part that changes a single-axis mesh's resolution under
default config: the small-message latency tier, which below
``latency_tier_threshold`` bytes picks the cheapest of the one-shot, flat
and tree schedules by the α-β cost model (flat for an allreduce at world 8).
The multi-axis, two-tier and full-authority searches are not ported: the
ranks of one card form a single axis, and on a single-axis mesh with
default config they return the ladder's decision. The registers that steer
them stay inert here.

Dispatch builds the XLA-role one-shot programs (:mod:`.primitives`), the
flat stars (:mod:`.flat`), the ring kernels and the segmented relays
(``PALLAS``), the explicit ring (:mod:`.ring`), the binary trees
(:mod:`.tree`), the 2-D hierarchical allreduce and, on an explicit request,
the two-tier schedules (:mod:`.hierarchical`). Every family AUTO can
resolve for allreduce, reduce-scatter, all-gather, bcast, scatter, gather,
reduce and alltoall builds; MULTIAXIS, which needs the synthesizer and which
AUTO never selects on a single-axis mesh, raises
``COLLECTIVE_NOT_IMPLEMENTED``. The MoE pair (:func:`build_alltoall_matmul`,
:func:`build_matmul_alltoall`) and the tensor-parallel collective matmuls
(:func:`build_allgather_matmul`, :func:`build_matmul_reduce_scatter`,
:func:`build_fsdp_matmul`) build their fused kernels on PALLAS and the
unfused pair otherwise; on the intra-node tier AUTO takes PALLAS from their
size registers up, in wire bytes (:func:`cmatmul_wire_bytes`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

from ..arithconfig import ArithConfig
from ..communicator import Communicator
from ..config import ACCLConfig, Algorithm, TransportBackend
from ..constants import (ACCLError, dataType, errorCode, operation,
                         reduceFunction)
from ..obs import metrics as _metrics
from . import (flat, hierarchical, pallas_chunked, pallas_ring, primitives,
               ring, tree)
from .hierarchical import factor2d

_SUPPORTED = {
    operation.bcast: {Algorithm.XLA, Algorithm.FLAT, Algorithm.TREE,
                      Algorithm.RING, Algorithm.PALLAS},
    operation.reduce: {Algorithm.XLA, Algorithm.FLAT, Algorithm.TREE,
                       Algorithm.RING, Algorithm.PALLAS},
    operation.allreduce: {Algorithm.XLA, Algorithm.FLAT, Algorithm.TREE,
                          Algorithm.RING, Algorithm.HIERARCHICAL,
                          Algorithm.PALLAS, Algorithm.MULTIAXIS,
                          Algorithm.TWOTIER},
    operation.allgather: {Algorithm.XLA, Algorithm.RING, Algorithm.PALLAS,
                          Algorithm.MULTIAXIS, Algorithm.TWOTIER},
    operation.reduce_scatter: {Algorithm.XLA, Algorithm.RING,
                               Algorithm.PALLAS, Algorithm.MULTIAXIS,
                               Algorithm.TWOTIER},
    operation.scatter: {Algorithm.XLA, Algorithm.FLAT, Algorithm.PALLAS},
    operation.gather: {Algorithm.XLA, Algorithm.FLAT, Algorithm.RING,
                       Algorithm.PALLAS},
    operation.alltoall: {Algorithm.XLA, Algorithm.FLAT, Algorithm.PALLAS},
    # the fused collective matmuls: the fused kernels or the unfused pair
    operation.allgather_matmul: {Algorithm.XLA, Algorithm.PALLAS},
    operation.matmul_reduce_scatter: {Algorithm.XLA, Algorithm.PALLAS},
    operation.alltoall_matmul: {Algorithm.XLA, Algorithm.PALLAS},
    operation.matmul_alltoall: {Algorithm.XLA, Algorithm.PALLAS},
}

#: the ops whose PALLAS register compares wire bytes
#: (:func:`cmatmul_wire_bytes`)
CMATMUL_OPS = (operation.allgather_matmul, operation.matmul_reduce_scatter,
               operation.alltoall_matmul, operation.matmul_alltoall)

#: the bandwidth collectives the JAX synthesizer resolves
SYNTH_OPS = (operation.allreduce, operation.allgather,
             operation.reduce_scatter)

#: legacy registers whose non-default value (an autotune seed) pins the
#: ladder's decision for the op they govern
_SEED_FIELDS = {
    operation.allreduce: ("ring_threshold", "hier_threshold",
                          "dcn_hier_threshold", "pallas_threshold"),
    operation.allgather: ("ag_ring_threshold", "ag_pallas_threshold"),
    operation.reduce_scatter: ("rs_ring_threshold", "rs_pallas_threshold"),
}

#: ROADMAP.md queue-1 item that ports each family or op still missing
_ROADMAP_ITEM = {
    Algorithm.MULTIAXIS: "queue 1, item 8 (parallel/synth.py)",
}


def supported(op: operation, algo: Algorithm) -> bool:
    return algo in _SUPPORTED.get(op, {Algorithm.XLA})


#: (algorithm, op) pairs already warned about; cleared per session
_warned_global_fallback: set = set()


def reset_global_fallback_warnings() -> None:
    _warned_global_fallback.clear()


def cmatmul_wire_bytes(op: operation, nbytes: int, cfg: ACCLConfig,
                       count: Optional[int] = None) -> int:
    """Wire bytes of a collective-matmul or fused all-to-all payload under
    the session wire dtype (``ACCLConfig.cmatmul_wire_dtype``). ``nbytes``
    follows the op's operand-byte convention; ``count`` (elements) gives
    the operand width, else f32 is assumed. A full-precision session, or a
    wire at least as wide as the operand, returns ``nbytes``."""
    name = cfg.cmatmul_wire_dtype
    if not name:
        return nbytes
    from ..ops import collective_matmul as cm
    wdt = cm._ALL_WIRE_NAMES.get(name)
    if wdt is None:
        return nbytes
    wisz = cm._itemsize(wdt)
    op_isz = (nbytes // count) if count else 4
    if op_isz <= wisz or op_isz <= 0:
        return nbytes
    return (nbytes // op_isz) * wisz


def _hier_shape(comm: Communicator, on_dcn: bool = False):
    """2-D split for the hierarchical allreduce: the host-aligned one on a
    multi-host group, else the most-square one; on DCN without a
    host-aligned shape there is none (the factor2d split would put the
    bandwidth-heavy phase on DCN links)."""
    hs = comm.hosts_shape()
    if hs is not None:
        return hs
    if on_dcn:
        return None
    return factor2d(comm.world_size)


def select(op: operation, nbytes: int, comm: Communicator, cfg: ACCLConfig,
           requested: Optional[Algorithm] = None,
           count: Optional[int] = None) -> Algorithm:
    """Resolve the algorithm for one call; every resolution is counted
    (``accl_algorithm_selected_total``)."""
    algo, _ = select_plan(op, nbytes, comm, cfg, requested, count)
    return algo


def select_plan(op: operation, nbytes: int, comm: Communicator,
                cfg: ACCLConfig, requested: Optional[Algorithm] = None,
                count: Optional[int] = None):
    """:func:`select` plus the source of the decision: ``"legacy"`` (the
    ladder), ``"latency_tier"``, or None (an explicit request, world 1, an
    op outside :data:`SYNTH_OPS`). The JAX package returns its
    ``SchedulePlan`` here; the port has no plans to carry yet."""
    algo, source = _select(op, nbytes, comm, cfg, requested, count)
    _metrics.inc("accl_algorithm_selected_total",
                 labels=(("op", op.name), ("algorithm", algo.value)))
    return algo, source


def _select(op, nbytes, comm, cfg, requested=None, count=None):
    algo = requested or cfg.algorithm
    if algo != Algorithm.AUTO:
        if supported(op, algo):
            return algo, None
        if requested is not None:
            raise ValueError(f"{algo} not supported for {op.name}")
        _metrics.inc("accl_algorithm_fallback_total",
                     labels=(("op", op.name), ("algorithm", algo.value)))
        if (algo, op) not in _warned_global_fallback:
            _warned_global_fallback.add((algo, op))
            from ..utils.logging import get_logger
            get_logger("algorithms").warning(
                "session algorithm %s unsupported for %s; using AUTO",
                algo.name, op.name)
    if comm.world_size == 1:
        return Algorithm.XLA, None
    legacy = _select_legacy(op, nbytes, comm, cfg, count)
    if op in SYNTH_OPS:
        if (cfg.sched_synthesis and cfg.transport != TransportBackend.DCN
                and nbytes < cfg.latency_tier_threshold
                and not _seed_overridden(op, cfg)):
            return _latency_choice(op, nbytes, comm.world_size, cfg), \
                "latency_tier"
        return legacy, "legacy"
    return legacy, None


def _seed_overridden(op: operation, cfg: ACCLConfig) -> bool:
    defaults = ACCLConfig()
    return any(getattr(cfg, f) != getattr(defaults, f)
               for f in _SEED_FIELDS.get(op, ()))


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) if n > 1 else 0


def _latency_choice(op: operation, nbytes: int, P: int,
                    cfg: ACCLConfig) -> Algorithm:
    """The latency tier (``synth.py:_latency_plan``): the argmin of the α-β
    cost over XLA's log-depth single shot, the 2-hop flat star and the
    binary tree; flat and tree exist for allreduce only. Ties keep the
    earlier candidate, as ``min`` does there."""
    alpha, beta = cfg.sched_alpha_us, cfg.sched_beta_gbps
    k = 2 if cfg.bidirectional_rings else 1
    N = nbytes * P if op == operation.allgather else nbytes
    lg = _ceil_log2(P)

    def step(hops, link_bytes, channels):
        return alpha * hops + float(link_bytes) / (max(channels, 1) * beta
                                                   * 1e3)

    per = N * (P - 1) / P
    if op == operation.allreduce:
        cands = [
            (Algorithm.XLA, sum([step(lg, per, k), step(lg, per, k)])),
            (Algorithm.FLAT, sum([step(1, N * (P - 1), 1),
                                  step(1, N * (P - 1), 1)])),
            (Algorithm.TREE, sum([step(lg, N * lg, k),
                                  step(lg, N * lg, k)])),
        ]
    else:
        cands = [(Algorithm.XLA, sum([step(lg, per, k)]))]
    return min(cands, key=lambda c: c[1])[0]


def _select_legacy(op: operation, nbytes: int, comm: Communicator,
                   cfg: ACCLConfig, count: Optional[int] = None) -> Algorithm:
    """The scalar-threshold ladder, as in the JAX package."""
    world = comm.world_size
    on_dcn = cfg.transport == TransportBackend.DCN
    if on_dcn:
        if op == operation.allreduce and nbytes >= cfg.dcn_hier_threshold:
            if comm.hosts_shape() is not None:
                return Algorithm.HIERARCHICAL
            _metrics.inc("accl_select_decline_total",
                         labels=(("op", op.name),
                                 ("reason", "dcn_no_host_shape")))
        if op in (operation.bcast, operation.reduce) \
                and nbytes > cfg.max_eager_size:
            return Algorithm.TREE
    if cfg.transport == TransportBackend.ICI:
        pallas_at = {
            operation.allreduce: cfg.pallas_threshold,
            operation.allgather: cfg.ag_pallas_threshold,
            operation.reduce_scatter: cfg.rs_pallas_threshold,
            operation.bcast: cfg.bcast_pallas_threshold,
            operation.gather: cfg.gather_pallas_threshold,
            operation.scatter: cfg.scatter_pallas_threshold,
            operation.alltoall: cfg.alltoall_pallas_threshold,
            operation.reduce: cfg.reduce_pallas_threshold,
            operation.allgather_matmul: cfg.ag_matmul_threshold,
            operation.matmul_reduce_scatter: cfg.rs_matmul_threshold,
            operation.alltoall_matmul: cfg.a2a_matmul_threshold,
            operation.matmul_alltoall: cfg.a2a_matmul_threshold,
        }.get(op)
        if op in CMATMUL_OPS:
            # the registers compare wire bytes
            nbytes = cmatmul_wire_bytes(op, nbytes, cfg, count)
        if pallas_at is not None and nbytes >= pallas_at:
            return Algorithm.PALLAS
    if op == operation.allreduce and nbytes >= cfg.hier_threshold:
        if _hier_shape(comm, on_dcn) is not None:
            return Algorithm.HIERARCHICAL
        _metrics.inc("accl_select_decline_total",
                     labels=(("op", op.name),
                             ("reason", "dcn_no_host_shape" if on_dcn
                              else "no_2d_shape")))
    if op == operation.allreduce and nbytes >= cfg.ring_threshold:
        return Algorithm.RING
    if op == operation.allgather and nbytes >= cfg.ag_ring_threshold:
        return Algorithm.RING
    if op == operation.reduce_scatter and nbytes >= cfg.rs_ring_threshold:
        return Algorithm.RING
    if nbytes > cfg.max_eager_size:
        if op == operation.bcast:
            return (Algorithm.FLAT
                    if world <= cfg.bcast_flat_tree_max_ranks
                    else Algorithm.TREE)
        if op == operation.reduce:
            small = count is not None and \
                count <= cfg.reduce_flat_tree_max_count
            return (Algorithm.FLAT
                    if world <= cfg.reduce_flat_tree_max_ranks or small
                    else Algorithm.TREE)
        if op in (operation.scatter, operation.gather, operation.alltoall):
            return Algorithm.FLAT
    return Algorithm.XLA


# ---------------------------------------------------------------------------
# builder dispatch
# ---------------------------------------------------------------------------

def _not_ported(op: operation, algo: Algorithm) -> ACCLError:
    where = _ROADMAP_ITEM.get(op, _ROADMAP_ITEM.get(algo, "a later slice"))
    return ACCLError(errorCode.COLLECTIVE_NOT_IMPLEMENTED,
                     f"{algo.name} {op.name} is not ported yet "
                     f"(ROADMAP.md {where})")


def _no_kernels(prog: Callable) -> Callable:
    """Give a program of plain torch operations the builders' interface,
    ``prog(x, errors=None)`` (``prog(x, dest, errors=None)`` for gather and
    reduce); it launches no kernel, so it has no error words to append."""
    return lambda *operands, errors=None: prog(*operands)


def _twotier_shape(comm: Communicator, mesh_shape=None) -> tuple:
    """(slices, per_slice) for a two-tier build: the given shape, else the
    physical slice boundary (``comm.hosts_shape()``), else, for explicit
    requests on one host or one card, the most-square factorization; a
    prime world raises."""
    if mesh_shape is not None:
        s = tuple(int(v) for v in mesh_shape)
        if len(s) != 2 or s[0] * s[1] != comm.world_size:
            raise ValueError(
                f"two-tier shape {s} != world {comm.world_size}")
        return s
    hs = comm.hosts_shape()
    if hs is not None:
        return tuple(hs)
    shape = factor2d(comm.world_size)
    if shape is None:
        raise ValueError(
            "two-tier collective needs a composite world with a "
            f"(slices, per_slice) split, got world={comm.world_size}")
    return tuple(shape)


def build_allreduce(comm, func: reduceFunction, dt: dataType, algo: Algorithm,
                    arith: Optional[ArithConfig],
                    segment_bytes: Optional[int] = None,
                    bidirectional: bool = False,
                    on_dcn: bool = False,
                    mesh_shape=None,
                    dcn_wire_dtype=None) -> Callable:
    if algo == Algorithm.TWOTIER:
        s2 = _twotier_shape(comm, mesh_shape)
        return _no_kernels(hierarchical.build_twotier_allreduce(
            comm, s2[0], s2[1], func, dt, arith,
            dcn_wire_dtype=dcn_wire_dtype))
    if algo == Algorithm.PALLAS:
        return pallas_ring.build_pallas_ring_allreduce(
            comm, func, dt, segment_bytes, arith=arith,
            bidirectional=bidirectional)
    if algo == Algorithm.FLAT:
        return _no_kernels(flat.build_flat_allreduce(comm, func, dt, arith))
    if algo == Algorithm.RING:
        return _no_kernels(ring.build_ring_allreduce(comm, func, dt, arith))
    if algo == Algorithm.TREE:
        return _no_kernels(tree.build_tree_allreduce(comm, func, dt, arith))
    if algo == Algorithm.HIERARCHICAL:
        # an explicit request on DCN without a host-aligned shape fails
        # loudly rather than take the factor2d split
        rc = _hier_shape(comm, on_dcn)
        if rc is None:
            raise ValueError(
                "hierarchical allreduce needs a composite world"
                + (" with a host-aligned 2-D shape on DCN" if on_dcn else "")
                + f", got world={comm.world_size}")
        return _no_kernels(hierarchical.build_hier_allreduce(
            comm, rc[0], rc[1], func, dt, arith))
    if algo == Algorithm.MULTIAXIS:
        raise _not_ported(operation.allreduce, algo)
    return _no_kernels(primitives.build_allreduce(comm, func, dt, arith))


def build_allgather(comm, algo: Algorithm, arith: Optional[ArithConfig],
                    dt: dataType, segment_bytes: Optional[int] = None,
                    bidirectional: bool = False,
                    mesh_shape=None,
                    dcn_wire_dtype=None) -> Callable:
    if algo == Algorithm.TWOTIER:
        s2 = _twotier_shape(comm, mesh_shape)
        return _no_kernels(hierarchical.build_twotier_allgather(
            comm, s2[0], s2[1], arith, dcn_wire_dtype=dcn_wire_dtype))
    if algo == Algorithm.PALLAS:
        return pallas_ring.build_pallas_ring_allgather(
            comm, dt, segment_bytes, arith=arith,
            bidirectional=bidirectional)
    if algo == Algorithm.RING:
        return _no_kernels(ring.build_ring_allgather(comm, arith))
    if algo == Algorithm.MULTIAXIS:
        raise _not_ported(operation.allgather, algo)
    return _no_kernels(primitives.build_allgather(comm, arith))


def build_reduce_scatter(comm, func: reduceFunction, dt: dataType,
                         algo: Algorithm, arith: Optional[ArithConfig],
                         segment_bytes: Optional[int] = None,
                         bidirectional: bool = False,
                         mesh_shape=None,
                         dcn_wire_dtype=None) -> Callable:
    if algo == Algorithm.TWOTIER:
        s2 = _twotier_shape(comm, mesh_shape)
        return _no_kernels(hierarchical.build_twotier_reduce_scatter(
            comm, s2[0], s2[1], func, dt, arith,
            dcn_wire_dtype=dcn_wire_dtype))
    if algo == Algorithm.PALLAS:
        return pallas_ring.build_pallas_ring_reduce_scatter(
            comm, func, dt, segment_bytes, arith=arith,
            bidirectional=bidirectional)
    if algo == Algorithm.RING:
        return _no_kernels(ring.build_ring_reduce_scatter(comm, func, dt,
                                                          arith))
    if algo == Algorithm.MULTIAXIS:
        raise _not_ported(operation.reduce_scatter, algo)
    return _no_kernels(primitives.build_reduce_scatter(comm, func, dt,
                                                       arith))


def _needs_dt(op: operation, dt: Optional[dataType]) -> None:
    if dt is None:
        raise ValueError(f"Algorithm.PALLAS {op.name} requires dt")


def build_bcast(comm, root: int, algo: Algorithm,
                arith: Optional[ArithConfig],
                dt: Optional[dataType] = None,
                segment_bytes: Optional[int] = None) -> Callable:
    if algo == Algorithm.PALLAS:
        _needs_dt(operation.bcast, dt)
        return pallas_chunked.build_chunked_ring_bcast(
            comm, root, dt, segment_bytes, arith=arith)
    if algo == Algorithm.FLAT:
        return _no_kernels(flat.build_flat_bcast(comm, root, arith))
    if algo == Algorithm.TREE:
        return _no_kernels(tree.build_tree_bcast(comm, root, arith))
    if algo == Algorithm.RING:
        return _no_kernels(ring.build_ring_bcast(comm, root, arith))
    return _no_kernels(primitives.build_bcast(comm, root, arith))


def build_scatter(comm, root: int, algo: Algorithm,
                  arith: Optional[ArithConfig],
                  dt: Optional[dataType] = None,
                  segment_bytes: Optional[int] = None) -> Callable:
    if algo == Algorithm.PALLAS:
        _needs_dt(operation.scatter, dt)
        return pallas_chunked.build_chunked_ring_scatter(
            comm, root, dt, segment_bytes, arith=arith)
    if algo == Algorithm.FLAT:
        return _no_kernels(flat.build_flat_scatter(comm, root, arith))
    return _no_kernels(primitives.build_scatter(comm, root, arith))


def build_gather(comm, root: int, algo: Algorithm,
                 arith: Optional[ArithConfig],
                 dt: Optional[dataType] = None,
                 segment_bytes: Optional[int] = None) -> Callable:
    """``prog(x, dest, errors=None)``. The JAX package's ``fanin`` argument
    throttles the flat star's concurrent edges, which ranks on one device
    do not need (:mod:`.flat`)."""
    if algo == Algorithm.PALLAS:
        _needs_dt(operation.gather, dt)
        return pallas_chunked.build_chunked_ring_gather(
            comm, root, dt, segment_bytes, arith=arith)
    if algo == Algorithm.FLAT:
        return _no_kernels(flat.build_flat_gather(comm, root, arith))
    if algo == Algorithm.RING:
        return _no_kernels(ring.build_ring_gather(comm, root, arith))
    return _no_kernels(primitives.build_gather(comm, root, arith))


def build_reduce(comm, root: int, func: reduceFunction, dt: dataType,
                 algo: Algorithm, arith: Optional[ArithConfig],
                 segment_bytes: Optional[int] = None) -> Callable:
    """``prog(x, dest, errors=None)``; no ``fanin``, as for gather."""
    if algo == Algorithm.PALLAS:
        return pallas_chunked.build_chunked_ring_reduce(
            comm, root, func, dt, segment_bytes, arith=arith)
    if algo == Algorithm.FLAT:
        return _no_kernels(flat.build_flat_reduce(comm, root, func, dt,
                                                  arith))
    if algo == Algorithm.TREE:
        return _no_kernels(tree.build_tree_reduce(comm, root, func, dt,
                                                  arith))
    if algo == Algorithm.RING:
        return _no_kernels(ring.build_ring_reduce(comm, root, func, dt,
                                                  arith))
    return _no_kernels(primitives.build_reduce(comm, root, func, dt, arith))


def build_alltoall(comm, algo: Algorithm, arith: Optional[ArithConfig],
                   dt: Optional[dataType] = None,
                   segment_bytes: Optional[int] = None) -> Callable:
    """(world, world*n) -> (world, world*n): chunk r of rank q lands at rank
    r, slot q."""
    if algo == Algorithm.PALLAS:
        _needs_dt(operation.alltoall, dt)
        return pallas_chunked.build_chunked_ring_alltoall(
            comm, dt, segment_bytes, arith=arith)
    if algo == Algorithm.FLAT:
        return _no_kernels(flat.build_flat_alltoall(comm, arith))
    return _no_kernels(primitives.build_alltoall(comm, arith))


def build_alltoall_matmul(comm, algo: Algorithm, bidirectional: bool = True,
                          wire_dtype=None) -> Callable:
    """(world, E, C, d) per-destination token blocks + (world, e_local, d,
    h) expert in-projections -> (world, e_local, world*C, h) f32:
    ``einsum(all_to_all(x), w)``. PALLAS runs the fused dispatch kernel
    (:mod:`..ops.collective_alltoall`), anything else the unfused pair.
    ``wire_dtype`` stages the token payload compressed ("off" pins full
    precision)."""
    from ..ops import collective_alltoall as ca
    overlap = algo == Algorithm.PALLAS

    def prog(x, w):
        return ca.alltoall_matmul_body(x, w, overlap=overlap,
                                       bidirectional=bidirectional,
                                       wire_dtype=wire_dtype)

    return prog


def build_matmul_alltoall(comm, algo: Algorithm, bidirectional: bool = True,
                          wire_dtype=None) -> Callable:
    """(world, e_local, world*C, hd) expert activations + (world, e_local,
    hd, d) out-projections -> (world, E, C, d) f32: ``all_to_all(einsum(h,
    w))``, the fused combine kernel under PALLAS."""
    from ..ops import collective_alltoall as ca
    overlap = algo == Algorithm.PALLAS

    def prog(h, w):
        return ca.matmul_alltoall_body(h, w, overlap=overlap,
                                       bidirectional=bidirectional,
                                       wire_dtype=wire_dtype)

    return prog


def build_allgather_matmul(comm, algo: Algorithm, bidirectional: bool = True,
                           wire_dtype=None) -> Callable:
    """(world, m, k) row shards + (world, k, n) weight blocks -> (world,
    world*m, n) f32: ``all_gather(x, rows) @ w``. PALLAS runs the fused
    kernel (:mod:`..ops.collective_matmul`, resident or streaming per the
    plan), anything else the unfused pair. ``wire_dtype`` stages the shards
    compressed ("off" pins full precision)."""
    from ..ops import collective_matmul as cm
    overlap = algo == Algorithm.PALLAS

    def prog(x, w):
        return cm.all_gather_matmul_body(x, w, overlap=overlap,
                                         bidirectional=bidirectional,
                                         wire_dtype=wire_dtype)

    return prog


def build_matmul_reduce_scatter(comm, algo: Algorithm,
                                bidirectional: bool = True,
                                wire_dtype=None) -> Callable:
    """(world, m, k) local rows + (world, k, n) weight blocks -> (world,
    m/world, n) f32: ``reduce_scatter(x @ w, rows)``, each hop's partial
    folded into the travelling accumulator under PALLAS."""
    from ..ops import collective_matmul as cm
    overlap = algo == Algorithm.PALLAS

    def prog(x, w):
        return cm.matmul_reduce_scatter_body(x, w, overlap=overlap,
                                             bidirectional=bidirectional,
                                             wire_dtype=wire_dtype)

    return prog


def build_fsdp_matmul(comm, algo: Algorithm, bidirectional: bool = True,
                      wire_dtype=None) -> Callable:
    """(world, m, k) local rows + (world, n/world, k) weight-column shards
    in travel layout -> (world, m, n) f32: ``x @ all_gather(wt).T``, the
    ZeRO/FSDP forward. PALLAS runs the agmm kernel on the travelling weight
    shard, anything else the unfused gather and matmul."""
    from ..ops import collective_matmul as cm
    overlap = algo == Algorithm.PALLAS

    def prog(x, wt):
        yt = cm.all_gather_matmul_body(wt, x.transpose(1, 2), overlap=overlap,
                                       bidirectional=bidirectional,
                                       wire_dtype=wire_dtype)
        return yt.transpose(1, 2)

    return prog


def build_pipeline_relay(comm, algo: Algorithm) -> Callable:
    """(world, n, d) forward payloads + (world, n, d) backward payloads ->
    the pair after one pipeline tick's relay: forward rows shift +1 rank,
    backward rows -1. PALLAS runs the relay kernel
    (:mod:`..ops.pipeline_relay`), anything else the roll pair. The
    standalone program form; the train steps compose the same op through
    :mod:`..models.pipeline`."""
    from ..ops import pipeline_relay as pr
    overlap = algo == Algorithm.PALLAS

    def prog(f, b):
        return pr.pp_relay(f, b, overlap=overlap)

    return prog
