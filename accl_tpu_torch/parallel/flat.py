"""Flat-tree programs (counterpart: ``accl_tpu/parallel/flat.py``); the
allreduce only, which the latency tier selects for small payloads.

Flat reduce to rank 0 then flat bcast from it: rank 0 folds every peer's
contribution in rank order, each arriving over one direct star edge with
per-edge wire compression, and every peer receives the result over its own
edge. Plain torch, in the one-shot programs' counted-baseline role.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..arithconfig import ArithConfig
from ..communicator import Communicator
from ..constants import dataType, reduceFunction
from .primitives import _fold_in, _unwire, _wire


def build_flat_allreduce(comm: Communicator, func: reduceFunction,
                         dt: dataType,
                         arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n). The JAX package's fan-in throttle
    (``gather_flat_tree_max_fanin``) only paces the star on a fabric and
    leaves the fold order unchanged, so ranks on one device need none."""
    world = comm.world_size

    def prog(x):
        acc = x[0]
        for src in range(1, world):
            acc = _fold_in(acc, _wire(x[src], arith), func, dt, arith)
        peer = _unwire(_wire(acc, arith), arith, acc.dtype)
        return torch.stack([acc] + [peer] * (world - 1))

    return prog
