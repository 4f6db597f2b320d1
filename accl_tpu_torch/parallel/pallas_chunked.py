"""Segmented ring collectives (counterpart:
``accl_tpu/parallel/pallas_chunked.py``): the reduce-scatter and all-gather
above ``pallas_ring.VMEM_PAYLOAD_THRESHOLD`` staged bytes, up to 1 GiB per
rank, the rooted collectives bcast, scatter, gather and reduce, and the
all-to-all.

Each chunk is cut into C segments of ``_geometry``'s size. Six kernels,
each with its plain PyTorch version, a launch counter and a wrapper (plain
version on CPU tensors, the CUDA kernel on CUDA tensors, no fallback):

* :func:`chunked_reduce_scatter` replaces
  ``pallas_chunked.py:_chunked_rs_kernel``: per segment the ring
  reduce-scatter of :func:`.pallas_ring.ring_reduce_scatter`; segment c
  rides channel c%2. With ``bidirectional`` channel 1 rotates left, so its
  segments end owning chunk (r-1)%P, folded in the other direction round
  the ring. Kernel: ``csrc/ring.cu:chunked_rs_kernel``.
* :func:`chunked_allgather` replaces ``pallas_chunked.py:_chunked_ag_kernel``;
  the output does not depend on the direction. Kernel:
  ``csrc/ring.cu:chunked_ag_kernel``.
* :func:`chunked_bcast` replaces ``_chunked_bcast_kernel``: the root's
  segments move one ring position per hop, pipelined. Kernel:
  ``bcast_relay_kernel``.
* :func:`chunked_scatter` replaces ``_chunked_scatter_kernel``: each of
  the root's blocks goes straight to its rank. Kernel:
  ``scatter_copy_kernel``.
* :func:`chunked_gather` replaces ``_chunked_gather_kernel``: each rank's
  block goes straight to its slot at the root. Kernel:
  ``gather_copy_kernel``.
* :func:`chunked_alltoall` replaces ``_chunked_alltoall_kernel``: each
  rank's chunk for rank r goes straight to slot s of rank r. Kernel:
  ``alltoall_copy_kernel``.

All are bound by device memory bandwidth. On the card the reduce-scatter's
and all-gather's two channels are separate CTA groups that run at once,
each with its own two staging slots and flag words; the credit chain runs
over a channel's global step counter across segment boundaries, as on the
TPU. The bcast relay is pure transport, run in the wire dtype on one
channel with readiness words per segment.

The scatter, gather and all-to-all depart from the TPU's schedule. The TPU
kernels relay their blocks round the ring because ICI links only
neighbours, so a block is read and written once per hop: P (P-1) / 2
block copies where a scatter or gather needs P - 1, and for the all-to-all
4x the function's bytes at P = 8. Every rank of this port lies in one HBM,
so the kernels copy each block once, from where it lies to where it
belongs, with the whole card and 16-byte accesses, and nothing waits: no
flags, no error word, an ordinary launch. Their bound is the function's
own, 2 (P-1) n elements moved for a scatter or gather and 2 P (P-1) n for
an all-to-all. They are pure transport too, run in the wire dtype, and
compute exactly what the TPU kernels do, bit for bit.

The bodies keep the JAX package's host-side policy: the stride padding of
each chunk into the uniform (P, C, S) grid, the per-parity realignment for
bidirectional rings, the wire policy, and what a rooted body keeps exact
(the root's own payload, block or partial, and every rank's own all-to-all
chunk, never ride the wire) or passes through (non-root rows of gather and
reduce keep the receive buffer).
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import constants, cuda_build
from ..communicator import Communicator
from ..constants import dataType, reduceFunction
from . import pallas_ring as _pr
from .pallas_ring import _LANES, _itemsize, _sublane

#: per-segment cap (bytes)
VMEM_SEGMENT_CAP = 1 << 20


def _seg_rows(segment_bytes: int, dtype) -> int:
    """Rows (of 128 lanes) per segment, honoring sublane tiling."""
    elems = max(segment_bytes // _itemsize(dtype), _LANES)
    rows = max(elems // _LANES, 1)
    mult = _sublane(dtype)
    return max(-(-rows // mult) * mult, mult)


def _geometry(chunk_elems: int, dtype, segment_bytes: int):
    """Segments per chunk, rows per segment and elements per segment."""
    sr = _seg_rows(min(segment_bytes, VMEM_SEGMENT_CAP), dtype)
    seg_elems = sr * _LANES
    C = max(-(-chunk_elems // seg_elems), 1)
    return C, sr, seg_elems


# ---------------------------------------------------------------------------
# kernel 6: segmented ring reduce-scatter (_chunked_rs_kernel)
# ---------------------------------------------------------------------------

def plain_chunked_reduce_scatter(x: torch.Tensor, func: reduceFunction,
                                 wire=None,
                                 bidirectional: bool = False) -> torch.Tensor:
    """x (P, P, C, S): rank r's chunk grid -> (P, C, S): rank r's folded
    segments of chunk (r+1)%P (odd segments of chunk (r-1)%P when
    ``bidirectional``), in the kernel's fold order; an int8 wire's SUM
    rounds each dequantize-and-add once, as the TPU kernel does."""
    if x.shape[0] == 1:
        return x[:, 0].clone()
    if not bidirectional or x.shape[2] == 1:
        return _pr._plain_rs(x, func, wire, 1, contract=True)
    out = torch.empty_like(x[:, 0])
    out[:, 0::2] = _pr._plain_rs(x[:, :, 0::2], func, wire, 1, contract=True)
    out[:, 1::2] = _pr._plain_rs(x[:, :, 1::2], func, wire, -1,
                                 contract=True)
    return out


def chunked_reduce_scatter(x: torch.Tensor, func: reduceFunction, wire=None,
                           bidirectional: bool = False,
                           errors=None) -> torch.Tensor:
    """Kernel 6 (replaces ``pallas_chunked.py:_chunked_rs_kernel``). Same
    contract as :func:`plain_chunked_reduce_scatter`; ``errors`` as in
    :mod:`.pallas_ring`."""
    if x.device.type != "cuda":
        return plain_chunked_reduce_scatter(x, func, wire, bidirectional)
    if x.shape[0] == 1:
        return x[:, 0].clone()
    out, flags = _pr._launch_rs(x, func, wire, bidirectional)
    chunked_reduce_scatter.launches += 1
    _pr._note_error_word(flags, "chunked_rs_kernel", errors)
    return out


chunked_reduce_scatter.launches = 0


# ---------------------------------------------------------------------------
# kernel 7: segmented ring all-gather (_chunked_ag_kernel)
# ---------------------------------------------------------------------------

def plain_chunked_allgather(x: torch.Tensor,
                            bidirectional: bool = False) -> torch.Tensor:
    """x (P, C, S): rank r's block -> (P, P, C, S), slot j = rank j's."""
    return _pr.plain_ring_allgather(x)


def chunked_allgather(x: torch.Tensor, bidirectional: bool = False,
                      errors=None) -> torch.Tensor:
    """Kernel 7 (replaces ``pallas_chunked.py:_chunked_ag_kernel``)."""
    if x.device.type != "cuda":
        return plain_chunked_allgather(x, bidirectional)
    if x.shape[0] == 1:
        return x.unsqueeze(0).clone()
    out, flags = _pr._launch_ag(1, x, bidirectional)
    chunked_allgather.launches += 1
    _pr._note_error_word(flags, "chunked_ag_kernel", errors)
    return out


chunked_allgather.launches = 0


# ---------------------------------------------------------------------------
# kernel 8: the bcast relay (_chunked_bcast_kernel)
# ---------------------------------------------------------------------------

#: the bcast relay's kernel kind (``KIND_BCAST`` of csrc/ring.cu)
_BCAST = 2


def _launch_relay(x: torch.Tensor, root: int):
    """Enqueue the bcast relay on the card; x (P, C, S): the ranks' inputs.
    Returns (out, flags); the caller checks the flags' error word."""
    P, C, S = x.shape
    what = "bcast_relay_kernel"
    _pr._check_cuda(x, what)
    _check_root(root, P, what)
    lib = cuda_build.load()
    size = _itemsize(x.dtype)
    dev = x.device
    B = _pr._grid(lib, _BCAST, 1, size, 0, P, 1, S, dev)
    out = torch.empty_like(x)
    flags = torch.zeros(P * B + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.accl_ring_relay(
            size, cuda_build.pointer_table(x), cuda_build.pointer_table(out),
            flags.data_ptr(), P, C, S, B, root, _pr.SPIN_TIMEOUT_S,
            cuda_build.stream_handle(dev))
    cuda_build.check(lib, rc, what)
    return out, flags


def _check_root(root: int, P: int, what: str) -> None:
    if not 0 <= root < P:
        raise ValueError(f"{what}: root {root} outside ranks 0..{P - 1}")


def plain_chunked_bcast(x: torch.Tensor, root: int) -> torch.Tensor:
    """x (P, C, S): the ranks' inputs, of which the root's is read -> (P, C,
    S): every row the root's payload. The kernel leaves row ``root``
    unwritten (the body keeps the root's input there)."""
    return x[root].expand_as(x).clone()


def chunked_bcast(x: torch.Tensor, root: int, errors=None) -> torch.Tensor:
    """Kernel 8 (replaces ``pallas_chunked.py:_chunked_bcast_kernel``). Same
    contract as :func:`plain_chunked_bcast`; ``errors`` as in
    :mod:`.pallas_ring`."""
    if x.device.type != "cuda":
        return plain_chunked_bcast(x, root)
    if x.shape[0] == 1:
        return x.clone()
    out, flags = _launch_relay(x, root)
    chunked_bcast.launches += 1
    _pr._note_error_word(flags, "bcast_relay_kernel", errors)
    return out


chunked_bcast.launches = 0


# ---------------------------------------------------------------------------
# kernels 9 and 11: the one-hop scatter and gather (_chunked_scatter_kernel,
# _chunked_gather_kernel)
# ---------------------------------------------------------------------------

def plain_chunked_scatter(x: torch.Tensor, root: int) -> torch.Tensor:
    """x (P, P, C, S): the ranks' inputs, of which the root's P blocks (by
    destination rank) are read -> (P, C, S): row r the root's block r. The
    kernel leaves row ``root`` unwritten (the body keeps the root's own
    block)."""
    return x[root].clone()


def chunked_scatter(x: torch.Tensor, root: int, errors=None) -> torch.Tensor:
    """Kernel 9 (replaces ``pallas_chunked.py:_chunked_scatter_kernel``).
    Same contract as :func:`plain_chunked_scatter`. The kernel waits on
    nothing, so it has no error word: ``errors`` is taken and left as it
    is."""
    if x.device.type != "cuda":
        return plain_chunked_scatter(x, root)
    P, _, C, S = x.shape
    if P == 1:
        return x[root].clone()
    what = "scatter_copy_kernel"
    _pr._check_cuda(x, what)
    _check_root(root, P, what)
    lib = cuda_build.load()
    dev = x.device
    out = torch.empty((P, C, S), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.accl_ring_scatter(
            _itemsize(x.dtype), x[root].data_ptr(),
            cuda_build.pointer_table(out), P, C * S, root,
            cuda_build.stream_handle(dev))
    cuda_build.check(lib, rc, what)
    chunked_scatter.launches += 1
    return out


chunked_scatter.launches = 0


def plain_chunked_gather(x: torch.Tensor, root: int,
                         out=None) -> torch.Tensor:
    """x (P, C, S): rank r's block -> (P, C, S): what the root gathers, slot
    j rank j's block. The kernel leaves slot ``root`` unwritten (the body
    inserts the root's own block); so does this version when it writes
    into a given ``out``."""
    if out is None:
        return x.clone()
    out[:root] = x[:root]
    out[root + 1:] = x[root + 1:]
    return out


def chunked_gather(x: torch.Tensor, root: int, errors=None,
                   out=None) -> torch.Tensor:
    """Kernel 11 (replaces ``pallas_chunked.py:_chunked_gather_kernel``).
    Same contract as :func:`plain_chunked_gather`: the root's (P, C, S)
    slots, written into ``out`` when given (contiguous, x's shape and
    dtype), else into a new tensor. No error word, as for
    :func:`chunked_scatter`."""
    if x.device.type != "cuda":
        return plain_chunked_gather(x, root, out)
    what = "gather_copy_kernel"
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype or
                            out.device != x.device or
                            not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    P, C, S = x.shape
    if P == 1:
        return x.clone() if out is None else out
    if out is None:
        out = torch.empty_like(x)
    _pr._check_cuda(x, what)
    _check_root(root, P, what)
    lib = cuda_build.load()
    dev = x.device
    with torch.cuda.device(dev):
        rc = lib.accl_ring_gather(
            _itemsize(x.dtype), cuda_build.pointer_table(x), out.data_ptr(),
            P, C * S, root, cuda_build.stream_handle(dev))
    cuda_build.check(lib, rc, what)
    chunked_gather.launches += 1
    return out


chunked_gather.launches = 0


# ---------------------------------------------------------------------------
# kernel 10: the one-hop all-to-all (_chunked_alltoall_kernel)
# ---------------------------------------------------------------------------

def plain_chunked_alltoall(x: torch.Tensor) -> torch.Tensor:
    """x (P, P, C, S): rank r's chunks by destination rank -> (P, P, C, S):
    rank r's chunks by source rank, ``o[r, s] = x[s, r]``. The kernel leaves
    ``o[r, r]`` unwritten (the body inserts the rank's own chunk)."""
    return x.transpose(0, 1).contiguous()


def chunked_alltoall(x: torch.Tensor, errors=None) -> torch.Tensor:
    """Kernel 10 (replaces ``pallas_chunked.py:_chunked_alltoall_kernel``).
    Same contract as :func:`plain_chunked_alltoall`, into a new tensor: an
    all-to-all in place is a transposition, and with a receive buffer that
    aliases the send buffer it would read blocks it has already written.
    No error word, as for :func:`chunked_scatter`."""
    if x.device.type != "cuda":
        return plain_chunked_alltoall(x)
    P, _, C, S = x.shape
    if P == 1:
        return x.clone()
    what = "alltoall_copy_kernel"
    _pr._check_cuda(x, what)
    lib = cuda_build.load()
    dev = x.device
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = lib.accl_ring_alltoall(
            _itemsize(x.dtype), cuda_build.pointer_table(x),
            cuda_build.pointer_table(out), P, C * S,
            cuda_build.stream_handle(dev))
    cuda_build.check(lib, rc, what)
    chunked_alltoall.launches += 1
    return out


chunked_alltoall.launches = 0


# ---------------------------------------------------------------------------
# bodies: padding, realignment
# ---------------------------------------------------------------------------

def _roll_into(dst: torch.Tensor, src: torch.Tensor, shift: int,
               dim: int) -> None:
    """dst = torch.roll(src, shift, dim) for shift = +-1, written as two
    slice copies (no temporary)."""
    n = src.shape[dim]
    if shift == 1:
        dst.narrow(dim, 1, n - 1).copy_(src.narrow(dim, 0, n - 1))
        dst.narrow(dim, 0, 1).copy_(src.narrow(dim, n - 1, 1))
    else:
        dst.narrow(dim, 0, n - 1).copy_(src.narrow(dim, 1, n - 1))
        dst.narrow(dim, n - 1, 1).copy_(src.narrow(dim, 0, 1))


def _pack_chunks(x: torch.Tensor, *, P: int, chunk: int, C: int,
                 seg_elems: int, dtype) -> torch.Tensor:
    """Stride-pad every rank's flat payload (P, n) into the kernels'
    (P, P, C, S) grid: chunk p is the first ``chunk`` elements of its
    C*S stride. A payload that already fills the grid is a view."""
    n = x.shape[-1]
    per = C * seg_elems
    if n == P * chunk and chunk == per and x.dtype == dtype \
            and x.is_contiguous():
        return x.view(P, P, C, seg_elems)
    src = torch.zeros((P, P * chunk), dtype=dtype, device=x.device)
    src[:, :n] = x
    grid = torch.zeros((P, P, per), dtype=dtype, device=x.device)
    grid[:, :, :chunk] = src.view(P, P, chunk)
    return grid.view(P, P, C, seg_elems)


def chunked_rs_body(x, *, P: int, func: reduceFunction, dtype,
                    segment_bytes: int, wire=None,
                    bidirectional: bool = False, errors=None):
    """(P, P*n) -> (P, n). ``bidirectional`` realigns per segment parity:
    even segments one hop forward, odd segments one hop back."""
    n = x.shape[-1] // P
    if P == 1:
        return x[:, :n].clone().to(dtype).to(x.dtype)
    C, _, seg_elems = _geometry(n, dtype, segment_bytes)
    grid = torch.zeros((P, P, C * seg_elems), dtype=dtype, device=x.device)
    grid[:, :, :n] = x.reshape(P, P, n)
    out = chunked_reduce_scatter(grid.view(P, P, C, seg_elems), func, wire,
                                 bidirectional, errors)
    mine = torch.empty_like(out)
    if bidirectional:
        _roll_into(mine[:, 0::2], out[:, 0::2], 1, 0)
        if C > 1:
            _roll_into(mine[:, 1::2], out[:, 1::2], -1, 0)
    else:
        _roll_into(mine, out, 1, 0)
    return mine.reshape(P, -1)[:, :n].to(x.dtype)


def chunked_ag_body(x, *, P: int, dtype, segment_bytes: int,
                    bidirectional: bool = False, errors=None):
    """(P, n) -> (P, P*n)."""
    n = x.shape[-1]
    if P == 1:
        return x
    C, _, seg_elems = _geometry(n, dtype, segment_bytes)
    padded = torch.zeros((P, C * seg_elems), dtype=dtype, device=x.device)
    padded[:, :n] = x
    out = chunked_allgather(padded.view(P, C, seg_elems), bidirectional,
                            errors)
    return out.reshape(P, P, C * seg_elems)[:, :, :n].reshape(P, P * n) \
        .to(x.dtype)


def chunked_ar_body(x, *, P: int, func: reduceFunction, dtype,
                    segment_bytes: int, wire=None, ag_wire=None,
                    bidirectional: bool = False, errors=None):
    """(P, n) -> (P, n): segmented ring reduce-scatter then segmented ring
    all-gather. ``wire`` compresses the reduce-scatter hops (full-precision
    fold), ``ag_wire`` the all-gather hops. ``bidirectional`` rolls even
    segments +1 and odd segments -1 along the source-rank axis (rank r's
    partial holds chunk (r+1)'s even and chunk (r-1)'s odd segments)."""
    n = x.shape[-1]
    if P == 1:
        return x
    chunk = -(-n // P)
    C, _, seg_elems = _geometry(chunk, dtype, segment_bytes)
    per = C * seg_elems
    chunks = _pack_chunks(x, P=P, chunk=chunk, C=C, seg_elems=seg_elems,
                          dtype=dtype)
    partial = chunked_reduce_scatter(chunks, func, wire, bidirectional,
                                     errors)
    if ag_wire is not None and ag_wire[0] != dtype:
        gathered = _pr._from_wire(
            chunked_allgather(_pr._to_wire(partial, ag_wire), bidirectional,
                              errors),
            dtype, ag_wire)
    else:
        gathered = chunked_allgather(partial, bidirectional, errors)
    ordered = torch.empty_like(gathered)
    if bidirectional:
        _roll_into(ordered[:, :, 0::2], gathered[:, :, 0::2], 1, 1)
        if C > 1:
            _roll_into(ordered[:, :, 1::2], gathered[:, :, 1::2], -1, 1)
    else:
        _roll_into(ordered, gathered, 1, 1)
    blocks = ordered.view(P, P, per)[:, :, :chunk]
    return blocks.reshape(P, P * chunk)[:, :n].to(x.dtype)


# ---------------------------------------------------------------------------
# rooted bodies and builders
# ---------------------------------------------------------------------------

def _root_grid(x, *, P: int, root: int, blocks: int, n: int, per: int, dtype,
               wire):
    """The bcast's and scatter's input grid (P, blocks, per), of which the
    kernels read row ``root`` only: the root's ``blocks`` blocks of ``n``
    elements, in the kernel dtype (``wire``'s, else ``dtype``), each
    zero-padded to ``per``. A payload already in that form is a view;
    otherwise the other rows are left unset."""
    if wire is None and n == per and x.dtype == dtype and x.is_contiguous():
        return x.view(P, blocks, per)
    src = x[root].view(blocks, n)
    src = _pr._to_wire(src, wire) if wire is not None else src.to(dtype)
    grid = torch.empty((P, blocks, per), dtype=src.dtype, device=x.device)
    grid[root, :, :n] = src
    grid[root, :, n:] = 0
    return grid


def _unwire_to(y, dtype, wire, out_dtype):
    """A rooted kernel's output back from the kernel dtype to
    ``out_dtype``."""
    if wire is not None:
        y = _pr._from_wire(y, dtype, wire)
    return y.to(out_dtype)


def chunked_bcast_body(x, *, P: int, root: int, dtype, segment_bytes: int,
                       wire=None, errors=None):
    """(P, n) -> (P, n): every rank gets the root's row. ``wire`` runs the
    whole relay in the wire dtype (pure transport); the root keeps its
    input exactly."""
    n = x.shape[-1]
    if P == 1:
        return x
    kdt = wire[0] if wire is not None else dtype
    C, _, seg_elems = _geometry(n, kdt, segment_bytes)
    grid = _root_grid(x, P=P, root=root, blocks=1, n=n, per=C * seg_elems,
                      dtype=dtype, wire=wire)
    out = chunked_bcast(grid.view(P, C, seg_elems), root, errors)
    res = _unwire_to(out.view(P, -1)[:, :n], dtype, wire, x.dtype)
    res[root] = x[root]
    return res


def chunked_scatter_body(x, *, P: int, root: int, dtype, segment_bytes: int,
                         wire=None, errors=None):
    """(P, P*n) -> (P, n): rank r gets block r of the root's row. ``wire``
    carries every block in the wire dtype; the root's own block never rides
    it and stays exact."""
    n = x.shape[-1] // P
    if P == 1:
        return x[:, :n].clone()
    kdt = wire[0] if wire is not None else dtype
    C, _, seg_elems = _geometry(n, kdt, segment_bytes)
    grid = _root_grid(x, P=P, root=root, blocks=P, n=n, per=C * seg_elems,
                      dtype=dtype, wire=wire)
    out = chunked_scatter(grid.view(P, P, C, seg_elems), root, errors)
    mine = _unwire_to(out.view(P, -1)[:, :n], dtype, wire, x.dtype)
    mine[root] = x[root, root * n:(root + 1) * n]
    return mine


def chunked_gather_body(x, dest, *, P: int, root: int, dtype,
                        segment_bytes: int, wire=None, errors=None):
    """(P, n), (P, P*n) -> (P, P*n): the root's row of ``dest`` (the receive
    buffer, written in place) gets every rank's block in rank order.
    ``wire`` carries every block in the wire dtype; the root's own block
    stays exact. Where no wire and no padding intervene the kernel writes
    the blocks straight into the root's row."""
    n = x.shape[-1]
    if P == 1:
        dest[root] = x[root]
        return dest
    kdt = wire[0] if wire is not None else dtype
    C, _, seg_elems = _geometry(n, kdt, segment_bytes)
    per = C * seg_elems
    xin = _pr._to_wire(x, wire) if wire is not None else x.to(dtype)
    if n == per and xin.is_contiguous():
        padded = xin.view(P, C, seg_elems)
    else:
        padded = torch.zeros((P, per), dtype=kdt, device=x.device)
        padded[:, :n] = xin
        padded = padded.view(P, C, seg_elems)
    row = dest[root]
    if wire is None and n == per and row.dtype == kdt and \
            row.is_contiguous():
        # the root's own block goes in first: x may be a view of dest (a
        # send buffer that is the receive buffer), where slot 0 of the
        # root's row is x[root] and the kernel overwrites it; it never
        # writes slot root, which for root > 0 does not overlap x[root]
        row[root * n:(root + 1) * n] = x[root]
        chunked_gather(padded, root, errors, out=row.view(P, C, seg_elems))
        return dest
    got = chunked_gather(padded, root, errors)
    flat = _unwire_to(got.reshape(P, per)[:, :n], dtype, wire, x.dtype)
    flat[root] = x[root]
    dest[root] = flat.reshape(-1)
    return dest


def chunked_reduce_body(x, *, P: int, root: int, func: reduceFunction,
                        dtype, segment_bytes: int, wire=None,
                        gather_wire=None, errors=None):
    """(P, n) -> (n,): the segmented ring reduce-scatter, then the one-hop
    gather of the folded chunks to the root: the root's result, in
    ``dtype``. ``wire`` compresses the reduce-scatter hops (full-precision
    fold), ``gather_wire`` the gather (pure transport); the root's own
    partial never rides the wire."""
    n = x.shape[-1]
    if P == 1:
        return x[root].to(dtype)
    chunk = -(-n // P)
    C, _, seg_elems = _geometry(chunk, dtype, segment_bytes)
    grid = _pack_chunks(x, P=P, chunk=chunk, C=C, seg_elems=seg_elems,
                        dtype=dtype)
    partial = chunked_reduce_scatter(grid, func, wire, False, errors)
    # the reduce-scatter's (P, C, S) output is the gather's input geometry
    if gather_wire is not None:
        gath = _pr._from_wire(
            chunked_gather(_pr._to_wire(partial, gather_wire), root, errors),
            dtype, gather_wire)
    else:
        gath = chunked_gather(partial, root, errors)
    blocks = gath.reshape(P, -1)[:, :chunk]          # by source rank
    blocks[root] = partial[root].reshape(-1)[:chunk]
    # source rank r folded chunk (r+1)%P: roll so slot c holds chunk c
    return torch.roll(blocks, 1, dims=0).reshape(-1)[:n]


def chunked_alltoall_body(x, *, P: int, dtype, segment_bytes: int,
                          wire=None, errors=None):
    """(P, P*n) -> (P, P*n): chunk d of rank r's row goes to rank d; slot s
    of rank r's result holds rank s's chunk for r. ``wire`` carries every
    chunk in the wire dtype (pure transport); a rank's own chunk never
    rides the wire and stays exact."""
    n = x.shape[-1] // P
    if P == 1:
        return x.clone()
    kdt = wire[0] if wire is not None else dtype
    C, _, seg_elems = _geometry(n, kdt, segment_bytes)
    per = C * seg_elems
    xin = x.reshape(P, P, n)
    wired = _pr._to_wire(xin, wire) if wire is not None else xin.to(dtype)
    if n == per and wired.is_contiguous():
        grid = wired
    else:
        grid = torch.zeros((P, P, per), dtype=kdt, device=x.device)
        grid[:, :, :n] = wired
    out = chunked_alltoall(grid.view(P, P, C, seg_elems), errors)
    blocks = _unwire_to(out.view(P, P, per)[:, :, :n], dtype, wire, x.dtype)
    ranks = torch.arange(P, device=x.device)
    blocks[ranks, ranks] = xin[ranks, ranks]
    return blocks.reshape(P, P * n)


def build_chunked_ring_alltoall(comm: Communicator, dt: dataType,
                                segment_bytes=None, arith=None) -> Callable:
    """(world, world*n) -> (world, world*n): one-hop all-to-all. A
    compressing ``arith`` carries every chunk in the wire dtype (pure
    transport)."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    wire = _transport_wire(arith)

    def prog(x, errors=None):
        return chunked_alltoall_body(x, P=P, dtype=dtype, segment_bytes=seg,
                                     wire=wire, errors=errors)

    return prog


def _transport_wire(arith):
    """(wire torch dtype, int8 scale or None) of a compressing arith config,
    else None: the rooted kernels and the all-to-all carry the wire dtype
    end to end."""
    if arith is None or not arith.is_compressing:
        return None
    return (constants.to_torch_dtype(arith.compressed), arith.quant_scale)


def build_chunked_ring_bcast(comm: Communicator, root: int, dt: dataType,
                             segment_bytes=None, arith=None) -> Callable:
    """(world, n) -> (world, n): pipelined ring broadcast. A compressing
    ``arith`` compresses every hop (pure transport). ``prog(x,
    errors=None)``, as every builder of :mod:`.pallas_ring`."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    wire = _transport_wire(arith)

    def prog(x, errors=None):
        return chunked_bcast_body(x, P=P, root=root, dtype=dtype,
                                  segment_bytes=seg, wire=wire, errors=errors)

    return prog


def build_chunked_ring_scatter(comm: Communicator, root: int, dt: dataType,
                               segment_bytes=None, arith=None) -> Callable:
    """(world, world*n) -> (world, n): one-hop scatter. A compressing
    ``arith`` carries every block in the wire dtype (pure transport)."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    wire = _transport_wire(arith)

    def prog(x, errors=None):
        return chunked_scatter_body(x, P=P, root=root, dtype=dtype,
                                    segment_bytes=seg, wire=wire,
                                    errors=errors)

    return prog


def build_chunked_ring_gather(comm: Communicator, root: int, dt: dataType,
                              segment_bytes=None, arith=None) -> Callable:
    """(world, n), (world, world*n) -> (world, world*n): one-hop gather
    into the root's row of ``dest`` (written in place); ``prog(x, dest,
    errors=None)``. A compressing ``arith`` carries every block in the wire
    dtype (pure transport)."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    wire = _transport_wire(arith)

    def prog(x, dest, errors=None):
        return chunked_gather_body(x, dest, P=P, root=root, dtype=dtype,
                                   segment_bytes=seg, wire=wire,
                                   errors=errors)

    return prog


def build_chunked_ring_reduce(comm: Communicator, root: int,
                              func: reduceFunction, dt: dataType,
                              segment_bytes=None, arith=None) -> Callable:
    """(world, n), (world, n) -> (world, n): segmented reduce-scatter then
    one-hop gather into the root's row of ``dest`` (written in place);
    ``prog(x, dest, errors=None)``. A compressing ``arith``
    compresses every hop of both phases, except that a kernel already
    running in the wire dtype (an ``arith_is_compressed`` pair) is not
    compressed again for the gather (a quantized scale would apply
    twice)."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    kdtype, wire, pre, post = _pr._wire_policy(arith, dtype)
    gather_wire = _transport_wire(arith)
    if gather_wire is not None and gather_wire[0] == kdtype:
        gather_wire = None

    def prog(x, dest, errors=None):
        out = chunked_reduce_body(pre(x), P=P, root=root, func=func,
                                  dtype=kdtype, segment_bytes=seg, wire=wire,
                                  gather_wire=gather_wire, errors=errors)
        dest[root] = post(out, x.dtype)
        return dest

    return prog
