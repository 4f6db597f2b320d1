"""Segmented ring reduce-scatter and all-gather (counterpart:
``accl_tpu/parallel/pallas_chunked.py``), the path above
``pallas_ring.VMEM_PAYLOAD_THRESHOLD`` staged bytes, up to 1 GiB per rank.

Each chunk is cut into C segments of ``_geometry``'s size; segment c rides
channel c%2. Two kernels, each with its plain PyTorch version, a launch
counter and a wrapper (plain version on CPU tensors, the CUDA kernel on
CUDA tensors, no fallback):

* :func:`chunked_reduce_scatter` replaces
  ``pallas_chunked.py:_chunked_rs_kernel``: per segment the ring
  reduce-scatter of :func:`.pallas_ring.ring_reduce_scatter`. With
  ``bidirectional`` channel 1 rotates left, so its segments end owning chunk
  (r-1)%P, folded in the other direction round the ring. Kernel:
  ``csrc/ring.cu:chunked_rs_kernel``.
* :func:`chunked_allgather` replaces ``pallas_chunked.py:_chunked_ag_kernel``;
  the output does not depend on the direction. Kernel:
  ``csrc/ring.cu:chunked_ag_kernel``.

Both are bound by device memory bandwidth. On the card the two channels are
separate CTA groups that run at once, each with its own two staging slots
and flag words; the credit chain runs over a channel's global step counter
across segment boundaries, as on the TPU.

The bodies keep the JAX package's host-side policy: the stride padding of
each chunk into the uniform (P, C, S) grid, the per-parity realignment for
bidirectional rings and the wire policy.
"""
from __future__ import annotations

import torch

from ..constants import reduceFunction
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
    ``bidirectional``), in the kernel's fold order."""
    if x.shape[0] == 1:
        return x[:, 0].clone()
    if not bidirectional or x.shape[2] == 1:
        return _pr._plain_rs(x, func, wire, 1)
    out = torch.empty_like(x[:, 0])
    out[:, 0::2] = _pr._plain_rs(x[:, :, 0::2], func, wire, 1)
    out[:, 1::2] = _pr._plain_rs(x[:, :, 1::2], func, wire, -1)
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
    out, flags = _pr._launch_rs(1, x, func, wire, bidirectional)
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
        return x[:, :n].to(dtype).to(x.dtype)
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
