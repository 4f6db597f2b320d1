"""Collective all-to-all x expert matmul, the MoE dispatch and combine
datapath (counterpart: ``accl_tpu/ops/collective_alltoall.py``), with their
backward.

Tensors carry every rank as a row of their first axis:

* :func:`alltoall_matmul`, **dispatch**: x (P, E, C, d), each rank's
  ``(e_local, C, d)`` token block per destination rank; w (P, e_local, d,
  h), each rank's expert in-projections. Returns (P, e_local, P*C, h) f32,
  source-rank-major: ``einsum(all_to_all(x), w)``.
* :func:`matmul_alltoall`, **combine**: h (P, e_local, P*C, hd), each
  rank's expert activations by destination; w (P, e_local, hd, d). Returns
  (P, E, C, d) f32: ``all_to_all(einsum(h, w))``.

Both are ``torch.autograd.Function``s and each other's duals, as the JAX
package's ``custom_vjp``s are: d(dispatch) routes dy home through the
combine with w transposed, d(combine) through the dispatch; dw of either is
:func:`a2a_gathered_wgrad_body`, the all-to-all of the travelling operand
folded into dw's per-expert contraction over token rows.

Three kernels, each with a plain PyTorch version, a launch counter and a
wrapper that runs the plain version on CPU tensors and launches the CUDA
kernel on CUDA tensors (or raises; there is no fallback):

* :func:`a2a_mm` replaces ``collective_alltoall.py:_a2a_mm_kernel``.
  Kernel: ``csrc/a2a.cu:a2a_mm_kernel``.
* :func:`mm_a2a` replaces ``collective_alltoall.py:_mm_a2a_kernel``; each
  y block, the local one too, is rounded once to the wire dtype (round to
  nearest even) and the body returns f32. Kernel:
  ``csrc/a2a.cu:mm_a2a_kernel``.
* :func:`a2a_wgrad` replaces ``collective_alltoall.py:_a2a_wgrad_kernel``:
  each (rank, expert) dw panel sums the source ranks' partials in the
  exchange's order (the local block, then step u of each channel). Kernel:
  ``csrc/a2a.cu:a2a_wgrad_kernel``.

On a TPU the exchange steps overlap the MXU work block by block; on one
card every source rank's block is a row of device memory, so each kernel
computes all (destination, source, expert) blocks at once as tiles of a
hand-written matmul that reads each block through the per-rank pointer
tables. The step order, channels and credits of the TPU kernels do not
change the forward's result there, so ``bidirectional`` only sets the plan's
channel count; the wgrad keeps the exchange's order of its sums. The
matmuls are bound by their f32 operations on the CUDA cores.

The policy is the JAX package's: the session switches and size register
(``ACCLConfig.moe_overlap``, ``moe_dw_overlap``, ``a2a_matmul_threshold``),
:func:`a2a_plan` and :func:`a2a_wgrad_plan`, the engage-reason vocabulary
(``off``, ``no_interpret``, ``threshold``, ``vmem_miss``) and the counted
fallbacks to the unfused pair (``accl_cmatmul_fallback_total{op, reason}``,
dw under ``op="moe_a2a_dw"``; a requested ``off`` is never counted). The
plans are the card's: operands stay in device memory and a block holds one
pair of f32 tiles in shared memory, so the capacity-bounded MoE shapes
engage where the TPU's 12 MiB VMEM plans miss.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import cuda_build
from ..constants import ACCLError, errorCode
from . import collective_matmul as cm

# ---------------------------------------------------------------------------
# session-level overlap switch + engage register
# (ACCLConfig.moe_overlap / a2a_matmul_threshold write-through)
# ---------------------------------------------------------------------------

_OVERLAP_DEFAULT = True
#: engage-at-or-above per-destination block wire bytes for the
#: ``overlap=None`` resolution; 0 until a session installs its value. An
#: explicit ``overlap=True`` bypasses it.
_A2A_THRESHOLD = 0


def set_overlap_enabled(enabled: bool) -> None:
    """Module default for the fused MoE path (``ACCLConfig.moe_overlap``
    lands here at every config assignment)."""
    global _OVERLAP_DEFAULT
    _OVERLAP_DEFAULT = bool(enabled)


def get_overlap_enabled() -> bool:
    return _OVERLAP_DEFAULT


def set_overlap_threshold(nbytes: int) -> None:
    """The session's fused-vs-unfused block-size register."""
    global _A2A_THRESHOLD
    _A2A_THRESHOLD = int(nbytes)


def get_overlap_threshold() -> int:
    return _A2A_THRESHOLD


#: the fused dw legs of the backward (``ACCLConfig.moe_dw_overlap``): False
#: keeps the unfused all-to-all + einsum for dw while dx stays fused, a
#: requested baseline that is never counted
_DW_OVERLAP_DEFAULT = True


def set_dw_overlap_enabled(enabled: bool) -> None:
    """Module default of the fused a2a-wgrad (``ACCLConfig.moe_dw_overlap``
    lands here at every config assignment)."""
    global _DW_OVERLAP_DEFAULT
    _DW_OVERLAP_DEFAULT = bool(enabled)


def get_dw_overlap_enabled() -> bool:
    return _DW_OVERLAP_DEFAULT


def _resolve(overlap: Optional[bool], nbytes: int) -> bool:
    """overlap=None: the session default and the block clears the size
    register; True/False: forced. Either way the kernels must run here."""
    if overlap is None:
        on = _OVERLAP_DEFAULT and nbytes >= _A2A_THRESHOLD
    else:
        on = bool(overlap)
    return on and cm._kernels_available()


def _fallback_reason(overlap: Optional[bool], op: str) -> None:
    """Count a policy-level fallback; an explicit or session overlap-off is
    a requested baseline, never counted."""
    if overlap is not None and not overlap:
        return
    if overlap is None and not _OVERLAP_DEFAULT:
        return
    cm._note_fallback(op, "no_interpret" if not cm._kernels_available()
                      else "threshold")


# ---------------------------------------------------------------------------
# kernels 17 and 18: a2a_mm_kernel, mm_a2a_kernel (csrc/a2a.cu)
# ---------------------------------------------------------------------------

#: output tile (rows = columns) and depth step of both kernels (a2a.cu)
_TILE, _BK = 64, 16
#: shared memory of one block: an f32 A and B tile (a2a.cu ``As``, ``Bs``)
_SMEM_BYTES = 2 * _BK * (_TILE + 4) * 4
#: shared memory one block may use on an H100 (227 KB)
_SMEM_BUDGET = 232448
#: largest y and z extent of a CUDA grid
_GRID_YZ = 65535
_DT_CODE = {torch.float16: 2, torch.float32: 3, torch.bfloat16: 7}


def _operand_codes(what: str, *tensors):
    """The dtype codes of the operands and output, after checking that all
    are contiguous on one device and the world fits the pointer tables."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what}: operands must be contiguous on one "
                             f"device")
    if tensors[0].shape[0] > 64:
        raise ValueError(f"{what}: at most 64 ranks, got "
                         f"{tensors[0].shape[0]}")
    codes = [_DT_CODE.get(t.dtype) for t in tensors]
    if None in codes:
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"{what} takes f32, bf16 or f16 operands, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    return codes


def _launch(combine: int, a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, C: int, what: str) -> None:
    """Enqueue one matmul kernel of csrc/a2a.cu: A rows by rank (x or h), B
    the ranks' expert weights (el, K, N), out by rank."""
    P, el, K, N = b.shape
    codes = _operand_codes(what, a, b, out)
    lib = cuda_build.load("a2a")
    with torch.cuda.device(a.device):
        rc = lib.accl_a2a_mm(combine, *codes, cuda_build.pointer_table(a),
                             cuda_build.pointer_table(b),
                             cuda_build.pointer_table(out), P, el, C, K, N,
                             cuda_build.stream_handle(a.device))
    cuda_build.check(lib, rc, what)


def plain_a2a_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (P, E, C, d) by destination, w (P, el, d, h) -> (P, el, P*C, h)
    f32: ``out[r, e, s*C:(s+1)*C] = x[s, r*el + e] @ w[r, e]``, products of
    the operands' f32 values."""
    P, E, C, d = x.shape
    el, h = w.shape[1], w.shape[3]
    recv = x.reshape(P, P, el, C, d).transpose(0, 1)     # [r, s, e, C, d]
    y = torch.einsum("rsecd,redh->resch", recv.float(), w.float())
    return y.reshape(P, el, P * C, h)


def a2a_mm(x: torch.Tensor, w: torch.Tensor,
           bidirectional: bool = False) -> torch.Tensor:
    """Kernel 17 (replaces ``collective_alltoall.py:_a2a_mm_kernel``). Same
    contract as :func:`plain_a2a_mm`; the result does not depend on
    ``bidirectional`` (the TPU kernel's channel split)."""
    if x.device.type != "cuda":
        return plain_a2a_mm(x, w)
    P, E, C, d = x.shape
    el, h = w.shape[1], w.shape[3]
    out = torch.empty((P, el, P * C, h), dtype=torch.float32,
                      device=x.device)
    _launch(0, x, w, out, C, "a2a_mm_kernel")
    a2a_mm.launches += 1
    return out


a2a_mm.launches = 0


def plain_mm_a2a(h: torch.Tensor, w: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """h (P, el, P*C, hd) by destination, w (P, el, hd, d) -> (P, E, C, d)
    in ``out_dtype``: ``out[r, s*el + e] = h[s, e, r*C:(r+1)*C] @ w[s, e]``
    in f32, rounded once."""
    P, el, PC, _ = h.shape
    C, d = PC // P, w.shape[3]
    y = torch.einsum("seph,sehd->sepd", h.float(), w.float()).to(out_dtype)
    return y.reshape(P, el, P, C, d).permute(2, 0, 1, 3, 4) \
        .reshape(P, P * el, C, d)


def mm_a2a(h: torch.Tensor, w: torch.Tensor, out_dtype=torch.float32,
           bidirectional: bool = False) -> torch.Tensor:
    """Kernel 18 (replaces ``collective_alltoall.py:_mm_a2a_kernel``). Same
    contract as :func:`plain_mm_a2a`."""
    if h.device.type != "cuda":
        return plain_mm_a2a(h, w, out_dtype)
    P, el, PC, _ = h.shape
    C, d = PC // P, w.shape[3]
    out = torch.empty((P, P * el, C, d), dtype=out_dtype, device=h.device)
    _launch(1, h, w, out, C, "mm_a2a_kernel")
    mm_a2a.launches += 1
    return out


mm_a2a.launches = 0


def _wgrad_sources(P: int, nchan: int):
    """The source-rank offsets of :func:`a2a_wgrad`'s sum, in the order of
    ``_a2a_wgrad_kernel``'s exchange: the local block, then for each step u
    channel 0's arrival from rank r - u and channel 1's from rank r + u
    (``_chan_steps``)."""
    steps = ((1, P - 1),) if nchan == 1 else ((1, P // 2), (-1, (P - 1) // 2))
    offs = [0]
    for u in range(1, max(T for _, T in steps) + 1):
        offs += [-sign * u for sign, T in steps if u <= T]
    return offs


def plain_a2a_wgrad(trav: torch.Tensor, loc: torch.Tensor, nchan: int = 1,
                    travel_lhs: bool = True) -> torch.Tensor:
    """trav (P, E, C, ct) blocks by destination, loc (P, el, P*C, cl) each
    rank's resident operand by source -> (P, el, ct, cl) f32 with
    ``out[r, e] = sum_s trav[s, r*el + e]ᵀ @ loc[r, e, s*C:(s+1)*C]``
    (``travel_lhs``), or (P, el, cl, ct) with the mirror ``locᵀ @ trav``:
    each source's partial of the operands' f32 values, summed in the order
    of :func:`_wgrad_sources`."""
    P, E, C, ct = trav.shape
    el, cl = loc.shape[1], loc.shape[3]
    t = trav.float().view(P, P, el, C, ct)              # [s, r, e, i, j]
    lb = loc.float().view(P, el, P, C, cl)              # [r, e, s, i, j]
    ranks = torch.arange(P, device=trav.device)
    acc = None
    for off in _wgrad_sources(P, nchan):
        src = (ranks + off) % P
        a, b = t[src, ranks], lb[ranks, :, src]         # (P, el, C, .)
        part = a.transpose(-2, -1) @ b if travel_lhs \
            else b.transpose(-2, -1) @ a
        acc = part if acc is None else acc + part
    return acc


def a2a_wgrad(trav: torch.Tensor, loc: torch.Tensor, nchan: int = 1,
              travel_lhs: bool = True) -> torch.Tensor:
    """Kernel 19 (replaces ``collective_alltoall.py:_a2a_wgrad_kernel``).
    Same contract as :func:`plain_a2a_wgrad`."""
    if trav.device.type != "cuda":
        return plain_a2a_wgrad(trav, loc, nchan, travel_lhs)
    P, E, C, ct = trav.shape
    el, cl = loc.shape[1], loc.shape[3]
    if tuple(loc.shape) != (P, el, P * C, cl) or E != P * el:
        raise ValueError(f"a2a_wgrad_kernel: loc {tuple(loc.shape)} does "
                         f"not match trav {tuple(trav.shape)}")
    out = torch.empty((P, el, ct, cl) if travel_lhs else (P, el, cl, ct),
                      dtype=torch.float32, device=trav.device)
    codes = _operand_codes("a2a_wgrad_kernel", trav, loc, out)[:2]
    lib = cuda_build.load("a2a")
    with torch.cuda.device(trav.device):
        rc = lib.accl_a2a_wgrad(*codes, int(travel_lhs),
                                cuda_build.pointer_table(trav),
                                cuda_build.pointer_table(loc),
                                cuda_build.pointer_table(out), P, el, C, ct,
                                cl, nchan,
                                cuda_build.stream_handle(trav.device))
    cuda_build.check(lib, rc, "a2a_wgrad_kernel")
    a2a_wgrad.launches += 1
    return out


a2a_wgrad.launches = 0


# ---------------------------------------------------------------------------
# block-geometry policy
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def a2a_plan(e_local: int, C: int, d: int, h: int, P: int, dtype,
             bidirectional: bool, direction: str = "dispatch",
             w_dtype=None, wire_dtype=None) -> Optional[dict]:
    """Geometry for one fused direction on the card, None when the kernel
    cannot take it (the fallback to the unfused pair, counted
    ``vmem_miss``). The operands stay in device memory and each block holds
    one f32 A and B tile in shared memory (``vmem_bytes``), far under the
    227 KB a block may use, so the limit is the grid: (source, row tile)
    and (destination, expert) pairs within 65535 blocks each. The dict keys
    are the JAX plan's; ``cp``, ``dp`` and ``hp`` are unpadded (the kernel
    masks ragged tiles), and the dtypes do not change the plan (the tiles
    are f32 whatever the operands)."""
    if e_local < 1 or C < 1 or d < 1 or h < 1 or P < 1:
        return None
    if direction not in ("dispatch", "combine"):
        raise ValueError(f"unknown a2a direction {direction!r}")
    nchan = 2 if (bidirectional and P >= 4) else 1
    if P * -(-C // _TILE) > _GRID_YZ or P * e_local > _GRID_YZ \
            or _SMEM_BYTES > _SMEM_BUDGET:
        return None
    return {"mode": "tiled", "cp": C, "dp": d, "hp": h, "nchan": nchan,
            "bidirectional": nchan == 2, "vmem_bytes": _SMEM_BYTES}


def a2a_engage_reason(e_local: int, C: int, d: int, h: int, P: int, dtype,
                      overlap: Optional[bool] = None,
                      bidirectional: bool = True,
                      wire_dtype=None, w_dtype=None,
                      direction: str = "dispatch") -> Optional[str]:
    """None when the fused kernel would run for these shapes under the
    given overlap mode, else the decline reason: ``"off"`` (a requested
    baseline, never counted), ``"no_interpret"``, ``"threshold"`` or
    ``"vmem_miss"``. ``dtype`` is the dtype the body sees for that
    direction (dispatch: the token payload; combine: the activations)."""
    if direction == "dispatch":
        wdt = cm._resolve_wire(wire_dtype, dtype)
        nbytes = e_local * C * d * _itemsize(wdt if wdt is not None
                                             else dtype)
    else:
        wdt = cm._resolve_wire(wire_dtype, torch.float32)
        nbytes = e_local * C * d * (_itemsize(wdt) if wdt is not None
                                    else 4)
    if (overlap is not None and not overlap) or \
            (overlap is None and not _OVERLAP_DEFAULT):
        return "off"
    if not cm._kernels_available():
        return "no_interpret"
    if overlap is None and nbytes < _A2A_THRESHOLD:
        return "threshold"
    if a2a_plan(e_local, C, d, h, P, dtype, bidirectional,
                direction=direction, w_dtype=w_dtype,
                wire_dtype=wdt) is None:
        return "vmem_miss"
    return None


def a2a_matmul_engages(e_local: int, C: int, d: int, h: int, P: int, dtype,
                       overlap: Optional[bool] = None,
                       bidirectional: bool = True,
                       wire_dtype=None, w_dtype=None,
                       direction: str = "dispatch") -> bool:
    """:func:`a2a_engage_reason` as a bool."""
    return a2a_engage_reason(e_local, C, d, h, P, dtype, overlap,
                             bidirectional, wire_dtype, w_dtype,
                             direction) is None


def a2a_wgrad_plan(e_local: int, C: int, ct: int, cl: int, P: int, dtype,
                   bidirectional: bool, loc_dtype=None,
                   wire_dtype=None) -> Optional[dict]:
    """Geometry of the fused a2a-wgrad on the card, None when the kernel
    cannot take it (the unfused pair, counted ``vmem_miss`` under
    ``op="moe_a2a_dw"``): one block per (rank, local expert, dw tile), so
    the (rank, expert) pairs and the row tiles of either orientation's dw
    panel must each stay within the grid's 65535, and a block's two f32
    tiles within shared memory. The dict keys are the JAX plan's; ``cp``,
    ``ctp`` and ``clp`` are unpadded (the kernel masks ragged tiles) and
    the dtypes do not change the plan. ``nchan`` orders the sum over source
    ranks as the TPU exchange's channels do."""
    if e_local < 1 or C < 1 or ct < 1 or cl < 1 or P < 1:
        return None
    nchan = 2 if (bidirectional and P >= 4) else 1
    if P * e_local > _GRID_YZ or -(-max(ct, cl) // _TILE) > _GRID_YZ \
            or _SMEM_BYTES > _SMEM_BUDGET:
        return None
    return {"mode": "tiled", "cp": C, "ctp": ct, "clp": cl, "nchan": nchan,
            "bidirectional": nchan == 2, "vmem_bytes": _SMEM_BYTES}


def a2a_wgrad_engage_reason(e_local: int, C: int, ct: int, cl: int, P: int,
                            dtype, overlap: Optional[bool] = None,
                            bidirectional: bool = True,
                            wire_dtype=None,
                            loc_dtype=None) -> Optional[str]:
    """None when the fused a2a-wgrad kernel would run in the backward's dw
    legs, else the decline reason: ``"off"`` covers an overlap-off request
    and ``ACCLConfig.moe_dw_overlap=False`` (requested baselines, never
    counted); ``"no_interpret"``, ``"threshold"`` and ``"vmem_miss"`` are
    counted under ``op="moe_a2a_dw"`` where the body declines. ``dtype`` is
    the traveller's."""
    wdt = cm._resolve_wire(wire_dtype, dtype)
    nbytes = e_local * C * ct * _itemsize(wdt if wdt is not None else dtype)
    if not _DW_OVERLAP_DEFAULT or \
            (overlap is not None and not overlap) or \
            (overlap is None and not _OVERLAP_DEFAULT):
        return "off"
    if not cm._kernels_available():
        return "no_interpret"
    if overlap is None and nbytes < _A2A_THRESHOLD:
        return "threshold"
    if a2a_wgrad_plan(e_local, C, ct, cl, P, dtype, bidirectional,
                      loc_dtype=loc_dtype, wire_dtype=wdt) is None:
        return "vmem_miss"
    return None


# ---------------------------------------------------------------------------
# the unfused pair (the fallback, and the baseline)
# ---------------------------------------------------------------------------

def _all_to_all_in(x: torch.Tensor, el: int) -> torch.Tensor:
    """(P, E, C, d) blocks by destination -> (P, el, P*C, d) by source."""
    P, _, C, d = x.shape
    return x.reshape(P, P, el, C, d).permute(1, 2, 0, 3, 4) \
        .reshape(P, el, P * C, d)


def _all_to_all_out(y: torch.Tensor) -> torch.Tensor:
    """(P, el, P*C, d) rows by destination -> (P, E, C, d) by source."""
    P, el, PC, d = y.shape
    C = PC // P
    return y.reshape(P, el, P, C, d).permute(2, 0, 1, 3, 4) \
        .reshape(P, P * el, C, d)


def xla_alltoall_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The sequential pair: the all-to-all, then the expert matmul in f32."""
    recv = _all_to_all_in(x, w.shape[1])
    return torch.einsum("repd,redh->reph", recv.float(), w.float())


def xla_matmul_alltoall(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The sequential pair: the expert matmul in f32, then the
    all-to-all."""
    y = torch.einsum("reph,rehd->repd", h.float(), w.float())
    return _all_to_all_out(y)


# ---------------------------------------------------------------------------
# bodies (shape checks and policy around the kernels)
# ---------------------------------------------------------------------------

def alltoall_matmul_body(x: torch.Tensor, w: torch.Tensor, *,
                         overlap: Optional[bool] = None,
                         bidirectional: bool = True, wire_dtype=None):
    """Dispatch: x (P, E, C, d), w (P, e_local, d, h) -> (P, e_local, P*C,
    h) f32. Falls back to the unfused pair on a plan miss or a declined
    threshold, each counted by reason."""
    P, E, C, d = x.shape
    P2, el, d2, h = w.shape
    if d2 != d or P2 != P:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if E % P or el != E // P:
        raise ValueError(
            f"expert blocks {E} must be world {P} x local experts {el}")
    if P == 1:
        return torch.einsum("recd,redh->rech", x.float(), w.float())
    wdt, sr = cm._resolve_wire_codec(wire_dtype, x.dtype)
    block_bytes = el * C * d * _itemsize(wdt if wdt is not None
                                         else x.dtype)
    plan = None
    if _resolve(overlap, block_bytes):
        plan = a2a_plan(el, C, d, h, P, x.dtype, bidirectional,
                        direction="dispatch", w_dtype=w.dtype,
                        wire_dtype=wdt)
        if plan is None:
            cm._note_fallback("alltoall_matmul", "vmem_miss")
    else:
        _fallback_reason(overlap, "alltoall_matmul")
    if plan is None:
        return xla_alltoall_matmul(x, w)
    xw = cm._wire_cast(x, wdt, stochastic=sr)
    return a2a_mm(xw.contiguous(), w.contiguous(), plan["bidirectional"])


def matmul_alltoall_body(h: torch.Tensor, w: torch.Tensor, *,
                         overlap: Optional[bool] = None,
                         bidirectional: bool = True, wire_dtype=None):
    """Combine: h (P, e_local, P*C, hd), w (P, e_local, hd, d) -> (P, E, C,
    d) f32. ``wire_dtype`` rounds each y block once (the local block too);
    the unfused fallback runs full precision."""
    P, el, PC, hd = h.shape
    P2, el2, h2, d = w.shape
    if h2 != hd or el2 != el or P2 != P:
        raise ValueError(f"contraction mismatch: h {tuple(h.shape)} vs w "
                         f"{tuple(w.shape)}")
    if PC % P:
        raise ValueError(f"activation rows {PC} not divisible by world {P}")
    C = PC // P
    if P == 1:
        return torch.einsum("reph,rehd->repd", h.float(), w.float())
    wdt = cm._resolve_wire(wire_dtype, torch.float32)
    block_bytes = el * C * d * (_itemsize(wdt) if wdt is not None else 4)
    plan = None
    if _resolve(overlap, block_bytes):
        plan = a2a_plan(el, C, d, hd, P, h.dtype, bidirectional,
                        direction="combine", w_dtype=w.dtype,
                        wire_dtype=wdt)
        if plan is None:
            cm._note_fallback("matmul_alltoall", "vmem_miss")
    else:
        _fallback_reason(overlap, "matmul_alltoall")
    if plan is None:
        return xla_matmul_alltoall(h, w)
    out = mm_a2a(h.contiguous(), w.contiguous(),
                 wdt if wdt is not None else torch.float32,
                 plan["bidirectional"])
    return out.float()


def a2a_gathered_wgrad_body(trav: torch.Tensor, loc: torch.Tensor, *,
                            overlap: Optional[bool] = None,
                            bidirectional: bool = True, wire_dtype=None,
                            travel_lhs: bool = True):
    """The fused dw of both backward passes: ``trav`` (P, E, C, ct) blocks
    by destination ride the exchange while each arrival's per-expert
    contraction against ``loc`` (P, e_local, P*C, cl), the source rank's
    row block, accumulates f32 into the dw panel. ``travel_lhs=True``
    returns (P, e_local, ct, cl) (d(dispatch): trav x, loc dy), False (P,
    e_local, cl, ct) (d(combine): trav dy, loc h): ``einsum`` of the
    exchanged traveller against ``loc``. Declines fall back to the unfused
    all-to-all and einsum, counted under ``op="moe_a2a_dw"``;
    ``ACCLConfig.moe_dw_overlap=False`` pins that baseline uncounted."""
    P, E, C, ct = trav.shape
    P2, el, PC, cl = loc.shape
    if P2 != P:
        raise ValueError(f"trav has {P} rank rows, loc has {P2}")
    if E % P or el != E // P:
        raise ValueError(
            f"traveller blocks {E} must be world {P} x local experts {el}")
    if PC != P * C:
        raise ValueError(
            f"local rows {PC} must be world {P} x block rows {C}")

    def _unfused(g):
        # the JAX body casts loc to the exchanged traveller's dtype, then
        # contracts in f32
        b = loc.to(g.dtype).float()
        if travel_lhs:
            return torch.einsum("rept,repl->retl", g.float(), b)
        return torch.einsum("repl,rept->relt", b, g.float())

    if P == 1:
        return _unfused(_all_to_all_in(trav, el))
    wdt, sr = cm._resolve_wire_codec(wire_dtype, trav.dtype)
    block_bytes = el * C * ct * _itemsize(wdt if wdt is not None
                                          else trav.dtype)
    plan = None
    if _DW_OVERLAP_DEFAULT:
        if _resolve(overlap, block_bytes):
            plan = a2a_wgrad_plan(el, C, ct, cl, P, trav.dtype,
                                  bidirectional, loc_dtype=loc.dtype,
                                  wire_dtype=wdt)
            if plan is None:
                cm._note_fallback("moe_a2a_dw", "vmem_miss")
        else:
            _fallback_reason(overlap, "moe_a2a_dw")
    # moe_dw_overlap=False: a requested baseline, never counted
    if plan is None:
        return _unfused(_all_to_all_in(trav, el))
    tw = cm._wire_cast(trav, wdt, stochastic=sr)
    return a2a_wgrad(tw.contiguous(), loc.contiguous(), plan["nchan"],
                     travel_lhs)


# ---------------------------------------------------------------------------
# entry points: dispatch and combine as each other's transposes
# ---------------------------------------------------------------------------

class _AlltoallMatmul(torch.autograd.Function):
    """``alltoall_matmul``'s forward and backward (the JAX package's
    ``_a2amm_fwd``/``_a2amm_bwd``): dx routes each source's cotangent block
    home through the combine with w transposed; dw = ``all_to_all(x)ᵀ @
    dy`` per expert, the a2a-wgrad with x travelling. A gradient no input
    needs is not computed."""

    @staticmethod
    def forward(ctx, x, w, overlap, bidirectional, wire_dtype):
        ctx.save_for_backward(x, w)
        ctx.opts = {"overlap": overlap, "bidirectional": bidirectional,
                    "wire_dtype": wire_dtype}
        return alltoall_matmul_body(x, w, **ctx.opts)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = matmul_alltoall_body(
                dy.to(x.dtype), w.transpose(2, 3).to(x.dtype),
                **ctx.opts).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = a2a_gathered_wgrad_body(x, dy, travel_lhs=True,
                                         **ctx.opts).to(w.dtype)
        return dx, dw, None, None, None


class _MatmulAlltoall(torch.autograd.Function):
    """``matmul_alltoall``'s forward and backward (``_mma2a_fwd``/
    ``_mma2a_bwd``): dh routes every destination's cotangent block back
    through the dispatch with w transposed; dw = ``hᵀ @ all_to_all(dy)``
    per expert, the a2a-wgrad with dy travelling."""

    @staticmethod
    def forward(ctx, h, w, overlap, bidirectional, wire_dtype):
        ctx.save_for_backward(h, w)
        ctx.opts = {"overlap": overlap, "bidirectional": bidirectional,
                    "wire_dtype": wire_dtype}
        return matmul_alltoall_body(h, w, **ctx.opts)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = alltoall_matmul_body(
                dy.to(h.dtype), w.transpose(2, 3).to(h.dtype),
                **ctx.opts).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = a2a_gathered_wgrad_body(dy.to(h.dtype), h, travel_lhs=False,
                                         **ctx.opts).to(w.dtype)
        return dh, dw, None, None, None


def alltoall_matmul(x: torch.Tensor, w: torch.Tensor,
                    overlap: Optional[bool] = None,
                    bidirectional: bool = True, wire_dtype=None):
    """MoE dispatch: ``einsum(all_to_all(x), w)``, x (P, E, C, d), w (P,
    e_local, d, h), out (P, e_local, P*C, h) f32. ``overlap=None`` follows
    the session default and size register; False pins the unfused pair.
    ``wire_dtype=None`` follows ``ACCLConfig.cmatmul_wire_dtype``.
    Differentiable: dx runs the dual combine, dw the a2a-wgrad."""
    return _AlltoallMatmul.apply(x, w, overlap, bidirectional, wire_dtype)


def matmul_alltoall(h: torch.Tensor, w: torch.Tensor,
                    overlap: Optional[bool] = None,
                    bidirectional: bool = True, wire_dtype=None):
    """MoE combine: ``all_to_all(einsum(h, w))``, h (P, e_local, P*C, hd),
    w (P, e_local, hd, d), out (P, E, C, d) f32. Differentiable: dh runs
    the dual dispatch, dw the a2a-wgrad."""
    return _MatmulAlltoall.apply(h, w, overlap, bidirectional, wire_dtype)
