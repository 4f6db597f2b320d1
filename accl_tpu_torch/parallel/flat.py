"""Flat-tree programs (counterpart: ``accl_tpu/parallel/flat.py``):
root-centric stars in which every transfer is one direct (root, peer) edge
with per-edge wire compression, never a relay.

* bcast: the root serves every peer; scatter: the root sends each peer its
  block; the root's own row or block stays exact.
* gather: every peer sends its block to the root; reduce: the root folds
  each peer's contribution into its own, ``combine(acc, moved)`` in
  arrival order root+1, root+2, ... Both write the root's row of the
  receive buffer in place; the other rows keep their content.
* allreduce (the latency tier's pick for small payloads): flat reduce to
  rank 0 then flat bcast from it.
* alltoall: P fused trees; at rotation step s every rank sends chunk
  (r+s)%P straight to its owner, each moved chunk through the wire, while
  the rank's own chunk is a local copy and stays exact.

The JAX package's fan-in throttle (``gather_flat_tree_max_fanin``) only
paces the star's concurrent edges on a fabric and leaves the fold order
unchanged, so ranks on one device need none. Plain torch, in the one-shot
programs' counted-baseline role.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..arithconfig import ArithConfig
from ..communicator import Communicator
from ..constants import dataType, reduceFunction
from .primitives import _fold_in, _unwire, _wire


def _edge(row, arith: Optional[ArithConfig]):
    """What one star edge delivers, a new tensor: ``row`` through the
    wire."""
    if arith is None or not arith.is_compressing:
        return row.clone()
    return _unwire(_wire(row, arith), arith, row.dtype)


def _peers(world: int, root: int):
    return [(root + i) % world for i in range(1, world)]


def build_flat_bcast(comm: Communicator, root: int,
                     arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n)."""
    world = comm.world_size

    def prog(x):
        out = _edge(x[root], arith).expand(world, -1).clone()
        out[root] = x[root]
        return out

    return prog


def build_flat_scatter(comm: Communicator, root: int,
                       arith: Optional[ArithConfig] = None) -> Callable:
    """(world, world*n) -> (world, n): rank r gets block r of the root's
    row."""
    world = comm.world_size

    def prog(x):
        blocks = x[root].view(world, -1)
        out = _edge(blocks, arith)
        out[root] = blocks[root]
        return out

    return prog


def build_flat_gather(comm: Communicator, root: int,
                      arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n), (world, world*n) -> (world, world*n): the root's row of
    ``dest`` gets every rank's block in rank order."""

    def prog(x, dest):
        got = _edge(x, arith)
        got[root] = x[root]
        dest[root] = got.reshape(-1)
        return dest

    return prog


def build_flat_reduce(comm: Communicator, root: int, func: reduceFunction,
                      dt: dataType,
                      arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n), (world, n) -> (world, n)."""
    world = comm.world_size

    def prog(x, dest):
        acc = x[root]
        for src in _peers(world, root):
            acc = _fold_in(acc, _wire(x[src], arith), func, dt, arith)
        dest[root] = acc
        return dest

    return prog


def build_flat_allreduce(comm: Communicator, func: reduceFunction,
                         dt: dataType,
                         arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n)."""
    world = comm.world_size

    def prog(x):
        acc = x[0]
        for src in range(1, world):
            acc = _fold_in(acc, _wire(x[src], arith), func, dt, arith)
        peer = _unwire(_wire(acc, arith), arith, acc.dtype)
        return torch.stack([acc] + [peer] * (world - 1))

    return prog


def build_flat_alltoall(comm: Communicator,
                        arith: Optional[ArithConfig] = None) -> Callable:
    """(world, world*n) -> (world, world*n): chunk r of rank q lands at rank
    r, slot q, through the wire; slot r of rank r is its own chunk,
    exact."""
    world = comm.world_size

    def prog(x):
        chunks = x.reshape(world, world, -1)
        moved = chunks
        if arith is not None and arith.is_compressing:
            moved = _unwire(_wire(chunks, arith), arith, x.dtype)
        out = torch.empty_like(chunks)
        out.copy_(moved.transpose(0, 1))
        ranks = torch.arange(world, device=x.device)
        out[ranks, ranks] = chunks[ranks, ranks]
        return out.view(world, -1)

    return prog
