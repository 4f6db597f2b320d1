"""In-program collectives (counterpart: ``accl_tpu/device_api.py``).

The JAX package calls these inside a ``shard_map`` body, one rank per
device. Here every rank is a row of the first axis of the tensors passed,
so a call acts on all ranks at once.

Ported so far: the MoE pair :func:`alltoall_matmul` and
:func:`matmul_alltoall`, the tensor-parallel collective matmuls
:func:`all_gather_matmul`, :func:`matmul_reduce_scatter` and
:func:`fsdp_matmul`, and the pipeline tick's relay :func:`pp_relay`, all
differentiable (the backward runs the dual fused kernels, the gathered
wgrads, or the channel-swapped relay). Still to port (ROADMAP.md queue 1,
item 10b): ``rank``, ``world``, ``allreduce``, ``reduce_to``, ``bcast``,
``scatter``, ``gather``, ``all_gather``, ``reduce_scatter``,
``all_to_all``, ``put_next``, ``get_prev``, ``send_recv``, ``combine`` and
``barrier``.
"""
from __future__ import annotations

from typing import Optional


def alltoall_matmul(x, w, overlap: Optional[bool] = None,
                    bidirectional: bool = True, wire_dtype=None):
    """MoE dispatch, ``einsum(all_to_all(x), w)``: x (world, E, C, d)
    per-destination token blocks, w (world, e_local, d, h) local expert
    in-projections, out (world, e_local, world*C, h) f32, through the fused
    dispatch kernel when its plan engages (:mod:`.ops.collective_alltoall`).
    ``overlap=None`` follows ``ACCLConfig.moe_overlap`` and the
    ``a2a_matmul_threshold`` register; ``wire_dtype=None`` follows
    ``ACCLConfig.cmatmul_wire_dtype``. Differentiable: dx through the
    fused combine, dw through the a2a-wgrad kernel."""
    from .ops import collective_alltoall as ca
    return ca.alltoall_matmul(x, w, overlap, bidirectional, wire_dtype)


def matmul_alltoall(h, w, overlap: Optional[bool] = None,
                    bidirectional: bool = True, wire_dtype=None):
    """MoE combine, ``all_to_all(einsum(h, w))``: h (world, e_local,
    world*C, hd) expert activations by destination, w (world, e_local, hd,
    d), out (world, E, C, d) f32, through the fused combine kernel. Same
    policy as :func:`alltoall_matmul`; ``wire_dtype`` rounds each block
    once."""
    from .ops import collective_alltoall as ca
    return ca.matmul_alltoall(h, w, overlap, bidirectional, wire_dtype)


def all_gather_matmul(x, w, overlap: Optional[bool] = None,
                      bidirectional: bool = True, wire_dtype=None):
    """``all_gather(x, rows) @ w`` (the Megatron column-parallel forward
    over a row-sharded LHS): x (world, m, k), w (world, k, n), out (world,
    world*m, n) f32, through the fused kernel when its plan engages
    (:mod:`.ops.collective_matmul`). ``overlap=None`` follows
    ``ACCLConfig.cmatmul_overlap`` and ``ag_matmul_threshold``;
    ``wire_dtype=None`` follows ``ACCLConfig.cmatmul_wire_dtype``.
    Differentiable: dx through the fused matmul x reduce-scatter, dw
    through the gathered-wgrad kernel."""
    from .ops import collective_matmul as cm
    return cm.all_gather_matmul(x, w, overlap, bidirectional, wire_dtype)


def matmul_reduce_scatter(x, w, overlap: Optional[bool] = None,
                          bidirectional: bool = True, wire_dtype=None):
    """``reduce_scatter(x @ w, rows)`` (the row-parallel combine): x (world,
    m, k), w (world, k, n), out (world, m/world, n) f32, each hop's partial
    folded into the travelling accumulator by the fused kernel.
    ``wire_dtype`` rounds the accumulator on the wire; the folds add in
    f32. Same policy as :func:`all_gather_matmul`."""
    from .ops import collective_matmul as cm
    return cm.matmul_reduce_scatter(x, w, overlap, bidirectional,
                                    wire_dtype)


def fsdp_matmul(x, wt_shard, overlap: Optional[bool] = None,
                bidirectional: bool = True, wire_dtype=None):
    """The ZeRO/FSDP forward ``x @ all_gather(wt_shard).T``: x (world, m,
    k), ``wt_shard`` (world, n/world, k) each rank's weight-column shard in
    travel layout, out (world, m, n) f32; the parameter gather rides the
    agmm kernel on the travelling shard. Same policy as
    :func:`all_gather_matmul`."""
    from .ops import collective_matmul as cm
    yt = cm.all_gather_matmul(wt_shard, x.transpose(1, 2), overlap,
                              bidirectional, wire_dtype)
    return yt.transpose(1, 2)


def pp_relay(fwd, bwd, overlap: Optional[bool] = None):
    """One pipeline tick's relay: ``fwd`` (world, n, d), or (world, L, n, d)
    with L independent lanes, shifts one rank forward (stage r's activation
    to stage r+1) while ``bwd`` shifts one rank back (the gradient's reverse
    hop), both in one launch of the relay kernel when its plan engages
    (:mod:`.ops.pipeline_relay`), the counted roll pair otherwise.
    ``overlap=None`` follows ``ACCLConfig.pp_overlap``. Differentiable: the
    backward is the same relay with the channels swapped."""
    from .ops import pipeline_relay as pr
    return pr.pp_relay(fwd, bwd, overlap)
