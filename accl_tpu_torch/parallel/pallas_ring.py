"""Ring reduce-scatter and all-gather (counterpart:
``accl_tpu/parallel/pallas_ring.py``).

Two kernels, each with a plain PyTorch version of the same function, a
launch counter and a wrapper that runs the plain version on CPU tensors
and launches the CUDA kernel on CUDA tensors (or raises; there is no
fallback):

* :func:`ring_reduce_scatter` replaces ``pallas_ring.py:_rs_kernel``. On
  the TPU rank r seeds the ring with its chunk r; at hop s it receives its
  upstream rank's partial, folds it with its own chunk (r-s-1)%P (received
  ⊕ local) and forwards the result; after P-1 hops it owns chunk (r+1)%P
  folded in ring order from that chunk's own rank. ``wire=(dtype, scale)``
  stages every forwarded partial compressed and decompresses it before the
  full-precision fold. Kernel: ``csrc/ring.cu:rs_fold_kernel``, which
  computes the same chains in one pass: every output element reads its P
  inputs once and folds them in that hop order, wire roundings included,
  so it equals the ring bit for bit with no hop, staging or flag.
* :func:`ring_allgather` replaces ``pallas_ring.py:_ag_kernel``: rank r's
  block lands in slot r of every rank after P-1 right-forward hops.
  Kernel: ``csrc/ring.cu:ring_ag_kernel``.

A launch is asynchronous. The all-gather's error word (set when a flag spin
timed out) is checked where the caller completes the work: a wrapper given
an ``errors`` list appends the word and returns at once, and the
:class:`..request.Request` of the host call reads every word of the call
after its one device sync; a wrapper given no list checks the word itself,
which waits for the launch. The fold waits on nothing and has no error
word: it takes ``errors`` and leaves the list as it is.

Both kernels are bound by device memory bandwidth (3.35 TB/s on an H100
SXM): they stream bytes and do at most one add per element read. The
all-gather keeps the TPU's schedule: one launch per ring phase, a group of
CTAs per rank, release/acquire flag words in place of DMA semaphores (see
``csrc/ring.cu``). The fold is an ordinary launch over (16-byte vectors of
a chunk, rank) with no flags: on one HBM a ring only multiplies traffic.

The builders keep the JAX package's host-side policy: padding each chunk
to whole (sublane x 128) tiles, the automatic switch to the segmented
kernels (:mod:`.pallas_chunked`) above ``VMEM_PAYLOAD_THRESHOLD`` staged
bytes, the wire policy of an ``ArithConfig``, and the realignment that
gives rank r chunk r. A program maps the ``(world, ...)`` tensor of all
ranks to all ranks' results.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import constants, cuda_build
from ..communicator import Communicator
from ..constants import ACCLError, dataType, errorCode, reduceFunction
from ..ops.registry import add_dequantized, dequantize, maximum, quantize

_LANES = 128

#: staged bytes (world x padded chunk) above which the builders switch to
#: the segmented kernels in :mod:`.pallas_chunked`
VMEM_PAYLOAD_THRESHOLD = 4 * 1024 * 1024

#: bound on every flag spin inside the kernels (seconds)
SPIN_TIMEOUT_S = 10.0

#: elements each thread handles per hop before the wrapper adds CTAs
_ELEMS_PER_THREAD = 4

#: size of a kernel's per-rank pointer table (``ACCL_MAX_RANKS``, ring.cu)
_MAX_RANKS = 64


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _sublane(dtype) -> int:
    return 16 if _itemsize(dtype) == 2 else 8


def _pad_rows(n_elems: int, dtype) -> int:
    rows = -(-n_elems // _LANES)
    mult = _sublane(dtype)
    return -(-rows // mult) * mult


def _staged_bytes(P: int, block_elems: int, dtype) -> int:
    return P * _pad_rows(block_elems, dtype) * _LANES * _itemsize(dtype)


def _combine(a, b, func: reduceFunction):
    return a + b if func == reduceFunction.SUM else maximum(a, b)


# ---------------------------------------------------------------------------
# wire policy: (wire torch dtype, int8 scale or None)
# ---------------------------------------------------------------------------

def _to_wire(x, wire):
    wdt, scale = wire
    if scale is not None:
        return quantize(x, scale, wdt)
    return x.to(wdt)


def _from_wire(x, cdt, wire):
    _, scale = wire
    if scale is not None:
        return dequantize(x.to(cdt), scale)
    return x.to(cdt)


def _wire_policy(arith, compute_dtype):
    """(kernel dtype, in-kernel wire, entry cast, exit cast) for an
    ArithConfig: casting/quantized pairs fold at full precision with the
    wire in the kernel; ``arith_is_compressed`` pairs run the whole kernel
    in the wire dtype; no compression is the identity."""
    if arith is None or not arith.is_compressing:
        return compute_dtype, None, (lambda x: x), (lambda y, od: y.to(od))
    wdt = constants.to_torch_dtype(arith.compressed)
    scale = arith.quant_scale
    if arith.arith_is_compressed:
        return (wdt, None,
                lambda x: _to_wire(x, (wdt, scale)),
                lambda y, od: _from_wire(y, od, (wdt, scale)))
    return (compute_dtype, (wdt, scale),
            (lambda x: x), (lambda y, od: y.to(od)))


# ---------------------------------------------------------------------------
# kernel launch plumbing (shared with pallas_chunked)
# ---------------------------------------------------------------------------

_capacity: Dict[Tuple, int] = {}


def _dt_code(dtype: torch.dtype) -> int:
    try:
        return int(constants.from_torch_dtype(dtype))
    except KeyError:
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"ring kernels take no {dtype}") from None


def _grid(lib, kind: int, chunked: int, code: int, wcode: int, P: int,
          nchan: int, S: int, device) -> int:
    """CTAs per (rank, channel): enough for ``_ELEMS_PER_THREAD`` elements
    per thread and hop, and never more than stay co-resident (every CTA of
    a ring waits on its neighbours, so all must run at once)."""
    key = (kind, chunked, code, wcode, device.index)
    cap = _capacity.get(key)
    if cap is None:
        c = ctypes.c_int()
        cuda_build.check(lib, lib.accl_ring_capacity(kind, chunked, code,
                                                     wcode, c),
                         "accl_ring_capacity")
        cap = _capacity[key] = c.value
    if P * nchan > cap:
        raise ACCLError(errorCode.CONFIG_ERROR,
                        f"{P} ranks x {nchan} channels exceed the "
                        f"{cap} co-resident CTAs of this card")
    want = -(-S // (lib.accl_ring_threads() * _ELEMS_PER_THREAD))
    return max(1, min(want, cap // (P * nchan)))


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what}: kernel input must be contiguous")
    if t.shape[0] > _MAX_RANKS:
        raise ValueError(f"{what}: at most {_MAX_RANKS} ranks, got "
                         f"{t.shape[0]}")


def _note_error_word(flags: torch.Tensor, what: str, errors) -> None:
    """The kernels' error word (last flag) is set when a flag spin timed
    out. Appended to ``errors`` when given; else read now, which waits for
    the launch."""
    if errors is not None:
        errors.append(flags[-1:])
    elif int(flags[-1].item()) != 0:
        raise ACCLError(errorCode.KRNL_TIMEOUT_STS_ERROR,
                        f"{what}: a ring hop waited over {SPIN_TIMEOUT_S} s")


def _rs_codes(x: torch.Tensor, wire, what: str):
    """(dtype code, wire dtype, wire code, int8 scale) of a reduce-scatter
    kernel launch; the scale is 1 where the wire has none."""
    wdt = wire[0] if wire is not None else x.dtype
    if wire is not None and (wdt == torch.int8) != (wire[1] is not None):
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"{what}: a scale goes with the int8 wire only, "
                        f"got {wire}")
    scale = float(wire[1]) if wire is not None and wire[1] is not None \
        else 1.0
    return _dt_code(x.dtype), wdt, _dt_code(wdt), scale


def _launch_rs(x: torch.Tensor, func: reduceFunction, wire,
               bidirectional: bool):
    """Enqueue one segmented reduce-scatter ring phase on the card. x: (P,
    P, C, S) -> (out (P, C, S), flags); the caller checks the flags' error
    word."""
    P, _, C, S = x.shape
    what = "chunked_rs_kernel"
    _check_cuda(x, what)
    lib = cuda_build.load()
    code, wdt, wcode, scale = _rs_codes(x, wire, what)
    nchan = min(2, C)
    dev = x.device
    B = _grid(lib, 0, 1, code, wcode, P, nchan, S, dev)
    out = torch.empty((P, C, S), dtype=x.dtype, device=dev)
    stage = torch.empty((P, 2, 2, S), dtype=wdt, device=dev)
    flags = torch.zeros(2 * P * 2 * B * 2 + 1, dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        rc = lib.accl_ring_rs(
            code, wcode, cuda_build.pointer_table(x),
            cuda_build.pointer_table(out), cuda_build.pointer_table(stage),
            flags.data_ptr(), P, C, S, B, nchan, int(bidirectional),
            int(func), scale, SPIN_TIMEOUT_S,
            cuda_build.stream_handle(dev))
    cuda_build.check(lib, rc, what)
    return out, flags


def _launch_ag(chunked: int, x: torch.Tensor, bidirectional: bool):
    """Enqueue one all-gather ring phase on the card. x: (P, C, S) ->
    (out (P, P, C, S), flags)."""
    P, C, S = x.shape
    what = "chunked_ag_kernel" if chunked else "ring_ag_kernel"
    _check_cuda(x, what)
    lib = cuda_build.load()
    size = _itemsize(x.dtype)
    nchan = min(2, C) if chunked else 1
    dev = x.device
    B = _grid(lib, 1, chunked, size, 0, P, nchan, S, dev)
    out = torch.empty((P, P, C, S), dtype=x.dtype, device=dev)
    flags = torch.zeros(P * 2 * B + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.accl_ring_ag(
            chunked, size, cuda_build.pointer_table(x),
            cuda_build.pointer_table(out), flags.data_ptr(), P, C, S, B,
            nchan, int(bidirectional), SPIN_TIMEOUT_S,
            cuda_build.stream_handle(dev))
    cuda_build.check(lib, rc, what)
    return out, flags


# ---------------------------------------------------------------------------
# kernel 4: ring reduce-scatter (_rs_kernel)
# ---------------------------------------------------------------------------

def _plain_rs(chunks, func: reduceFunction, wire, d: int,
              contract: bool = False):
    """The ring reduce-scatter schedule on a (P, P, ...) stack of every
    rank's chunks, rotating by ``d`` (+1: send right). ``contract``: an
    int8 SUM folds its dequantize-and-add with one rounding, as XLA
    compiles the segmented TPU kernel (a fused multiply-add); the
    VMEM-range kernel rounds the product and the sum apart."""
    P = chunks.shape[0]
    ranks = torch.arange(P, device=chunks.device)
    send = chunks[ranks, ranks]
    if wire is not None:
        send = _to_wire(send, wire)
    fma = contract and func == reduceFunction.SUM and wire is not None \
        and wire[1] is not None
    for s in range(P - 1):
        recv = torch.roll(send, d, dims=0)        # from rank r - d
        local = chunks[ranks, (ranks - d * (s + 1)) % P]
        if fma:
            folded = add_dequantized(local, recv, wire[1])
        else:
            if wire is not None:
                recv = _from_wire(recv, chunks.dtype, wire)
            folded = _combine(recv, local, func)
        send = folded if wire is None else _to_wire(folded, wire)
    return folded


def plain_ring_reduce_scatter(chunks: torch.Tensor, func: reduceFunction,
                              wire=None) -> torch.Tensor:
    """chunks (P, P, L): rank r's P chunks -> (P, L): rank r's folded chunk
    (r+1)%P, in the kernel's fold order."""
    if chunks.shape[0] == 1:
        return chunks[:, 0].clone()
    return _plain_rs(chunks, func, wire, 1)


def ring_reduce_scatter(chunks: torch.Tensor, func: reduceFunction,
                        wire=None, errors=None) -> torch.Tensor:
    """Kernel 4 (replaces ``pallas_ring.py:_rs_kernel``;
    ``csrc/ring.cu:rs_fold_kernel``). Same contract as
    :func:`plain_ring_reduce_scatter`. The kernel waits on nothing, so it
    has no error word: ``errors`` is taken and left as it is."""
    if chunks.device.type != "cuda":
        return plain_ring_reduce_scatter(chunks, func, wire)
    P, _, L = chunks.shape
    if P == 1:
        return chunks[:, 0].clone()
    what = "rs_fold_kernel"
    _check_cuda(chunks, what)
    lib = cuda_build.load()
    code, _, wcode, scale = _rs_codes(chunks, wire, what)
    dev = chunks.device
    out = torch.empty((P, L), dtype=chunks.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.accl_ring_rs_fold(
            code, wcode, cuda_build.pointer_table(chunks),
            cuda_build.pointer_table(out), P, L, int(func), scale,
            cuda_build.stream_handle(dev))
    cuda_build.check(lib, rc, what)
    ring_reduce_scatter.launches += 1
    return out


ring_reduce_scatter.launches = 0


# ---------------------------------------------------------------------------
# kernel 5: ring all-gather (_ag_kernel)
# ---------------------------------------------------------------------------

def plain_ring_allgather(block: torch.Tensor) -> torch.Tensor:
    """block (P, ...): rank r's block -> (P, P, ...): every rank holds
    every block, slot j = rank j's."""
    P = block.shape[0]
    return block.unsqueeze(0).expand(P, *block.shape).contiguous()


def ring_allgather(block: torch.Tensor, errors=None) -> torch.Tensor:
    """Kernel 5 (replaces ``pallas_ring.py:_ag_kernel``). block (P, L) ->
    (P, P, L)."""
    if block.device.type != "cuda":
        return plain_ring_allgather(block)
    P, L = block.shape
    if P == 1:
        return block.view(1, 1, L).clone()
    out, flags = _launch_ag(0, block.view(P, 1, L), False)
    ring_allgather.launches += 1
    _note_error_word(flags, "ring_ag_kernel", errors)
    return out.view(P, P, L)


ring_allgather.launches = 0


# ---------------------------------------------------------------------------
# builders: host-side padding, wire policy and realignment
# ---------------------------------------------------------------------------

def build_pallas_ring_allgather(comm: Communicator, dt: dataType,
                                segment_bytes: Optional[int] = None,
                                arith=None,
                                bidirectional: bool = False) -> Callable:
    """(world, n) -> (world, world*n). Payloads staging more than
    ``VMEM_PAYLOAD_THRESHOLD`` go to the segmented kernel. A compressing
    ``arith`` runs the whole ring in the wire dtype. Like every builder
    here, the program is ``prog(x, errors=None)``: kernel launches append
    their error words to ``errors`` (see the module docstring)."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    compressing = arith is not None and arith.is_compressing
    if compressing:
        wire = (constants.to_torch_dtype(arith.compressed), arith.quant_scale)
        kdtype = wire[0]
    else:
        kdtype = dtype

    def prog(x, errors=None):
        n = x.shape[-1]
        out_dtype = x.dtype
        if compressing:
            x = _to_wire(x, wire)
        if _staged_bytes(P, n, kdtype) > VMEM_PAYLOAD_THRESHOLD:
            from . import pallas_chunked
            out = pallas_chunked.chunked_ag_body(
                x, P=P, dtype=kdtype, segment_bytes=seg,
                bidirectional=bidirectional, errors=errors)
        else:
            L = _pad_rows(n, kdtype) * _LANES
            xt = torch.zeros((P, L), dtype=kdtype, device=x.device)
            xt[:, :n] = x
            out = ring_allgather(xt, errors)[:, :, :n].reshape(P, P * n)
        if compressing:
            out = _from_wire(out, out_dtype, wire)
        return out.to(out_dtype)

    return prog


def build_pallas_ring_reduce_scatter(comm: Communicator,
                                     func: reduceFunction, dt: dataType,
                                     segment_bytes: Optional[int] = None,
                                     arith=None,
                                     bidirectional: bool = False) -> Callable:
    """(world, world*n) -> (world, n). The kernel leaves rank r with chunk
    (r+1)%P; the program shifts it so rank r returns chunk r."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    kdtype, wire, pre, post = _wire_policy(arith, dtype)

    def prog(x, errors=None):
        n = x.shape[-1] // P
        out_dtype = x.dtype
        x = pre(x)
        if _staged_bytes(P, n, kdtype) > VMEM_PAYLOAD_THRESHOLD:
            from . import pallas_chunked
            out = pallas_chunked.chunked_rs_body(
                x, P=P, func=func, dtype=kdtype, segment_bytes=seg,
                wire=wire, bidirectional=bidirectional, errors=errors)
        else:
            L = _pad_rows(n, kdtype) * _LANES
            chunks = torch.zeros((P, P, L), dtype=kdtype, device=x.device)
            chunks[:, :, :n] = x.reshape(P, P, n)
            out = ring_reduce_scatter(chunks, func, wire, errors)
            out = torch.roll(out[:, :n], 1, dims=0)
        return post(out, out_dtype)

    return prog


def build_pallas_ring_allreduce(comm: Communicator, func: reduceFunction,
                                dt: dataType,
                                segment_bytes: Optional[int] = None,
                                arith=None,
                                bidirectional: bool = False) -> Callable:
    """(world, n) -> (world, n): ring reduce-scatter then ring all-gather.
    With a compressing ``arith`` both phases' hops carry the wire dtype:
    the reduce-scatter per the fold policy, the all-gather as transport."""
    P = comm.world_size
    dtype = constants.to_torch_dtype(dt)
    seg = segment_bytes or constants.DEFAULT_SEGMENT_SIZE
    kdtype, wire, pre, post = _wire_policy(arith, dtype)
    compressing = arith is not None and arith.is_compressing
    ag_wire = ((constants.to_torch_dtype(arith.compressed),
                arith.quant_scale) if compressing else None)

    def prog(x, errors=None):
        n = x.shape[-1]
        chunk = -(-n // P)
        out_dtype = x.dtype
        if _staged_bytes(P, chunk, kdtype) > VMEM_PAYLOAD_THRESHOLD:
            from . import pallas_chunked
            out = pallas_chunked.chunked_ar_body(
                pre(x), P=P, func=func, dtype=kdtype, segment_bytes=seg,
                wire=wire, ag_wire=ag_wire, bidirectional=bidirectional,
                errors=errors)
            return post(out, out_dtype)
        xx = pre(x)
        L = _pad_rows(chunk, kdtype) * _LANES
        padded = torch.zeros((P, P * chunk), dtype=kdtype, device=x.device)
        padded[:, :n] = xx
        chunks = torch.zeros((P, P, L), dtype=kdtype, device=x.device)
        chunks[:, :, :chunk] = padded.view(P, P, chunk)
        partial = ring_reduce_scatter(chunks, func, wire, errors)
        if wire is not None:
            gathered = _from_wire(
                ring_allgather(_to_wire(partial, wire), errors), kdtype, wire)
        else:
            gathered = ring_allgather(partial, errors)
        # slot j holds the partial of rank j = chunk (j+1)%P; roll so slot
        # c holds chunk c, then trim the padding
        ordered = torch.roll(gathered[:, :, :chunk], 1, dims=1)
        return post(ordered.reshape(P, P * chunk)[:, :n], out_dtype)

    return prog
