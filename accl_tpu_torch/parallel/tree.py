"""Binary-tree all-reduce (counterpart: ``accl_tpu/parallel/tree.py``); the
tree bcast and reduce come with the rooted collectives.

Reduce to rank 0 over ceil(log2 P) rounds of halving senders, then
broadcast from it over as many rounds of doubling senders, each hop wire
compressed. The JAX package runs every round as a masked ``ppermute``; here
the ranks are rows of one tensor, so a round moves the senders' rows onto
their receivers' in one indexed update. The fold ``combine(own, received)``
and the round order are the JAX package's, so results are bit-equal. Plain
torch, as the JAX package's XLA collectives are.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

from ..arithconfig import ArithConfig
from ..communicator import Communicator
from ..constants import dataType, reduceFunction
from .primitives import _fold_in, _unwire, _wire


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) if n > 1 else 0


def build_tree_allreduce(comm: Communicator, func: reduceFunction,
                         dt: dataType,
                         arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n): reduce-to-0 then broadcast-from-0."""
    world = comm.world_size
    rounds = _ceil_log2(world)

    def prog(x):
        acc = x.clone()
        for k in range(rounds):
            half = 1 << k
            src = [i for i in range(world) if i % (2 * half) == half]
            dst = [i - half for i in src]
            acc[dst] = _fold_in(acc[dst], _wire(acc[src], arith), func, dt,
                                arith)
        for k in range(rounds):
            half = 1 << k
            src = [i for i in range(half) if i + half < world]
            dst = [i + half for i in src]
            acc[dst] = _unwire(_wire(acc[src], arith), arith, acc.dtype)
        return acc

    return prog
