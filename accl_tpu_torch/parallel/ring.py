"""Explicit ring collectives (counterpart: ``accl_tpu/parallel/ring.py``):
the ring all-reduce, all-gather and reduce-scatter, and the rooted ring
reduce (a daisy chain root+1 -> root+2 -> ... -> root, each receiver
folding ``combine(received, own)``), gather (every rank relays toward the
root, one rank back per hop) and bcast (every rank relays to the next).

The JAX package runs each rank's step of the ring as a ``ppermute`` inside
``shard_map``. Here every rank is a row of one ``(world, ...)`` tensor, so
one step of all ranks is one set of torch operations: a hop (:func:`_hop`,
compress -> move to the next rank, decompressed where it lands) is a roll
of the rows, and each rank's choice of chunk is an index per row. A ring
all-reduce is 2(P-1) such steps. Chunk ownership, step indices, the
per-hop wire compression and the fold ``combine(local, received)`` are
the JAX package's, so a result is bit-equal to it (the ring's fold order
is fixed).

These programs are plain torch, in the role the JAX package's XLA
collectives play: no hand kernel carries them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..arithconfig import ArithConfig
from ..communicator import Communicator
from ..constants import dataType, reduceFunction
from .primitives import _fold_in, _unwire, _wire


def _hop(buf: torch.Tensor, arith: Optional[ArithConfig],
         shift: int = 1) -> torch.Tensor:
    """One ring hop of every rank, returning what arrived in the wire
    dtype: compress -> rank r's row moves to rank r+shift."""
    return torch.roll(_wire(buf, arith), shift, dims=0)


def _pick(ch: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row r's chunk idx[r] of a (P, P, chunk) stack."""
    return ch[torch.arange(ch.shape[0], device=ch.device), idx]


def _put(ch: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    ch[torch.arange(ch.shape[0], device=ch.device), idx] = val


def build_ring_allreduce(comm: Communicator, func: reduceFunction,
                         dt: dataType,
                         arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n): ring reduce-scatter + ring all-gather,
    2(P-1) steps moving n/P elements each."""
    world = comm.world_size

    def prog(x):
        n = x.shape[-1]
        chunk = -(-n // world)
        chunks = torch.zeros((world, world * chunk), dtype=x.dtype,
                             device=x.device)
        chunks[:, :n] = x
        chunks = chunks.view(world, world, chunk)
        rank = torch.arange(world, device=x.device)
        # phase 1: at step s rank r sends partial chunk (r-s) and folds the
        # received one into its chunk (r-s-1)
        for s in range(world - 1):
            moved = _hop(_pick(chunks, (rank - s) % world), arith)
            recv_idx = (rank - s - 1) % world
            _put(chunks, recv_idx,
                 _fold_in(_pick(chunks, recv_idx), moved, func, dt, arith))
        # rank r now owns the reduced chunk (r+1) mod P; phase 2 circulates
        for s in range(world - 1):
            moved = _hop(_pick(chunks, (rank + 1 - s) % world), arith)
            _put(chunks, (rank - s) % world, _unwire(moved, arith, x.dtype))
        return chunks.reshape(world, -1)[:, :n]

    return prog


def build_ring_allgather(comm: Communicator,
                         arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, world*n): P-1 hops, each rank forwarding what it
    received last step."""
    world = comm.world_size

    def prog(x):
        n = x.shape[-1]
        rank = torch.arange(world, device=x.device)
        out = torch.zeros((world, world, n), dtype=x.dtype, device=x.device)
        _put(out, rank, x)
        buf = x
        for s in range(world - 1):
            buf = _unwire(_hop(buf, arith), arith, x.dtype)
            _put(out, (rank - s - 1) % world, buf)
        return out.reshape(world, -1)

    return prog


def build_ring_reduce_scatter(comm: Communicator, func: reduceFunction,
                              dt: dataType,
                              arith: Optional[ArithConfig] = None
                              ) -> Callable:
    """(world, world*count) -> (world, count): rank r ends with the reduced
    chunk r."""
    world = comm.world_size

    def prog(x):
        chunks = x.reshape(world, world, -1).clone()
        rank = torch.arange(world, device=x.device)
        for s in range(world - 1):
            moved = _hop(_pick(chunks, (rank - s - 1) % world), arith)
            recv_idx = (rank - s - 2) % world
            _put(chunks, recv_idx,
                 _fold_in(_pick(chunks, recv_idx), moved, func, dt, arith))
        return _pick(chunks, rank)

    return prog


def build_ring_reduce(comm: Communicator, root: int, func: reduceFunction,
                      dt: dataType,
                      arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n), (world, n) -> (world, n): the partial travels root+1 ->
    root+2 -> ... -> root, P-1 full-row hops; the root's row of ``dest``
    gets the fold."""
    world = comm.world_size

    def prog(x, dest):
        acc = x.clone()
        for s in range(world - 1):
            src, dst = (root + s + 1) % world, (root + s + 2) % world
            acc[dst] = _fold_in(acc[dst], _wire(acc[src], arith), func, dt,
                                arith, moved_first=True)
        dest[root] = acc[root]
        return dest

    return prog


def build_ring_gather(comm: Communicator, root: int,
                      arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n), (world, world*n) -> (world, world*n): every rank sends its
    block one rank back (toward the root) and relays what it received, so
    rank root+s's block reaches the root after s hops, through the wire at
    each, into the root's row of ``dest``; the root's own block stays
    exact."""
    world = comm.world_size

    def prog(x, dest):
        slots = dest[root].view(world, -1)
        slots[root] = x[root]
        buf = x
        for s in range(1, world):
            buf = _unwire(_hop(buf, arith, -1), arith, x.dtype)
            slots[(root + s) % world] = buf[root]
        return dest

    return prog


def build_ring_bcast(comm: Communicator, root: int,
                     arith: Optional[ArithConfig] = None) -> Callable:
    """(world, n) -> (world, n): rank root+s receives from root+s-1 at hop
    s, through the wire; the root keeps its row exactly."""
    world = comm.world_size

    def prog(x):
        buf = x.clone()
        for s in range(world - 1):
            src, dst = (root + s) % world, (root + s + 1) % world
            buf[dst] = _unwire(_wire(buf[src], arith), arith, buf.dtype)
        return buf

    return prog
