"""Binary-tree collectives (counterpart: ``accl_tpu/parallel/tree.py``):
bcast, reduce and the all-reduce.

A broadcast runs ceil(log2 P) rounds of doubling senders (round k: relative
position i < 2^k sends to i + 2^k), a reduce as many rounds of halving
senders (an odd multiple of 2^k sends to its position - 2^k, which folds
it in); positions are relative to the root, each hop wire compressed. The
all-reduce is reduce-to-0 then broadcast-from-0. The JAX package runs every round as a masked ``ppermute``; here
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


def build_tree_bcast(comm: Communicator, root: int,
                     arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n): every rank gets the root's row, the root's
    own exactly."""
    world = comm.world_size
    rounds = _ceil_log2(world)

    def prog(x):
        buf = x.clone()
        for k in range(rounds):
            half = 1 << k
            rel = [i for i in range(half) if i + half < world]
            src = [(root + i) % world for i in rel]
            dst = [(root + i + half) % world for i in rel]
            buf[dst] = _unwire(_wire(buf[src], arith), arith, buf.dtype)
        return buf

    return prog


def build_tree_reduce(comm: Communicator, root: int, func: reduceFunction,
                      dt: dataType,
                      arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n), (world, n) -> (world, n): the root's row of ``dest`` gets
    the fold, ``combine(own, received)`` per round."""
    world = comm.world_size
    rounds = _ceil_log2(world)

    def prog(x, dest):
        acc = x.clone()
        for k in range(rounds):
            half = 1 << k
            rel = [i for i in range(world) if i % (2 * half) == half]
            src = [(root + i) % world for i in rel]
            dst = [(root + i - half) % world for i in rel]
            acc[dst] = _fold_in(acc[dst], _wire(acc[src], arith), func, dt,
                                arith)
        dest[root] = acc[root]
        return dest

    return prog


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
