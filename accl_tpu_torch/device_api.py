"""In-program collectives (counterpart: ``accl_tpu/device_api.py``).

The JAX package calls these inside a ``shard_map`` body, one rank per
device. Here every rank is a row of the first axis of the tensors passed,
so a call acts on all ranks at once.

Ported so far: the MoE pair :func:`alltoall_matmul` and
:func:`matmul_alltoall`. Still to port (ROADMAP.md queue 1, item 10):
``rank``, ``world``, ``allreduce``, ``reduce_to``, ``bcast``, ``scatter``,
``gather``, ``all_gather``, ``reduce_scatter``, ``all_to_all``, the
collective matmuls (``all_gather_matmul``, ``matmul_reduce_scatter``,
``fsdp_matmul``), ``pp_relay``, ``put_next``, ``get_prev``,
``send_recv``, ``combine`` and ``barrier``.
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
    ``ACCLConfig.cmatmul_wire_dtype``. Forward only: an input that requires
    grad raises."""
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
