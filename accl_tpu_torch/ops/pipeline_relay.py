"""Pipeline activation relay (counterpart: ``accl_tpu/ops/pipeline_relay.py``),
the pp axis's wire of :mod:`..models.pipeline`.

A 1F1B pipeline tick moves two payloads at once: microbatch i's forward
activation one stage forward (+1 ring hop) and microbatch i-k's gradient one
stage back (-1 hop). Payloads carry the stage axis leading: (P, n, d), or
(P, L, n, d) with L independent lanes (the (dp, tp) ranks of a (pp, dp, tp)
mesh each shift along pp apart from the others).

One kernel, with its plain PyTorch version, a launch counter and a wrapper
(plain version on CPU tensors, the CUDA kernel on CUDA tensors, no
fallback):

* :func:`relay` replaces ``pipeline_relay.py:_relay_kernel`` (the credit-
  gated, double-buffered remote-DMA hop, called from ``_relay_call``).
  Kernel: ``csrc/pipeline.cu:pp_relay_kernel``, one launch per tick for
  every stage row, lane and both channels. On one card the inputs are
  complete at launch and each output byte is written once, so the TPU's
  landing slots, credits and barrier have no work to do; the JAX plan's C
  segments stay the unit of work, and the padding into the (C, sr, 128)
  grid and the copy back are dropped.

The policy is the JAX package's: the session register ``pp_overlap``
(:func:`set_overlap_enabled`), the plan :func:`pp_plan` (its 12 MiB VMEM
budget kept so that decisions equal the JAX package's), the engage reasons
of :func:`relay_engage_reason` and the counters ``accl_pp_relay_total
{path}`` and ``accl_cmatmul_fallback_total{op="pp_relay"}``. The baseline
and counted fallback is the roll pair (the ``ppermute`` pair of the JAX
package). :func:`pp_relay` is differentiable: the cotangent of a +1 shift
is a -1 shift, so its backward is the same relay with the channels swapped.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import cuda_build
from ..obs import metrics as _metrics
from ..parallel.pallas_chunked import _seg_rows
from ..parallel.pallas_ring import _LANES, _itemsize
from . import collective_matmul as _cm

#: the fallback-counter op label (accl_cmatmul_fallback_total{op=...})
PP_OP = "pp_relay"

#: per-segment cap (bytes): on the TPU 2 channels x (2 send + 2 recv) slots
#: stay resident, so 1 MiB segments bound the kernel to ~8 MiB of VMEM
VMEM_SEGMENT_CAP = 1 << 20

#: the JAX package's scoped budget for the relay's resident slots
_VMEM_BUDGET = 12 << 20

#: ranks the kernel's pointer tables hold
_MAX_RANKS = 64


# ---------------------------------------------------------------------------
# session register (ACCLConfig.pp_overlap write-through); per-call override
# on pp_relay
# ---------------------------------------------------------------------------

_OVERLAP_DEFAULT = True


def set_overlap_enabled(enabled: bool) -> None:
    """Module-default relay mode (``ACCLConfig.pp_overlap`` lands here on
    every config assignment). Per-call override: ``pp_relay(overlap=)``."""
    global _OVERLAP_DEFAULT
    _OVERLAP_DEFAULT = bool(enabled)


def get_overlap_enabled() -> bool:
    return _OVERLAP_DEFAULT


# ---------------------------------------------------------------------------
# geometry plan + engage policy
# ---------------------------------------------------------------------------

def pp_plan(n: int, d: int, dtype, P: int) -> Optional[dict]:
    """Segment geometry for one (n, d) relay payload per direction, number
    for number the JAX plan: C segments of (sr, 128) elements; the resident
    VMEM it would take on a TPU, 2 channels x 4 slots x segment. None when
    even the minimum segment misses the budget."""
    if n < 1 or d < 1 or P < 2:
        return None
    item = _itemsize(dtype)
    elems = n * d
    seg_bytes = min(VMEM_SEGMENT_CAP, max(elems * item, 1))
    sr = _seg_rows(seg_bytes, dtype)
    seg_elems = sr * _LANES
    C = max(-(-elems // seg_elems), 1)
    vmem = 2 * 4 * seg_elems * item
    if vmem > _VMEM_BUDGET:
        return None
    return {"C": C, "sr": sr, "seg_elems": seg_elems, "vmem_bytes": vmem}


def relay_engage_reason(n: int, d: int, dtype, P: int,
                        overlap: Optional[bool] = None) -> Optional[str]:
    """None when :func:`pp_relay` would run the kernel for this payload;
    otherwise the decline reason in the ``accl_cmatmul_fallback_total``
    vocabulary: ``"off"`` (explicit or session overlap-off, a requested
    baseline, never counted), ``"geometry"`` (a one-stage ring has no hop),
    ``"no_interpret"`` or ``"vmem_miss"`` (kept from the JAX vocabulary;
    segmentation makes it unreachable today)."""
    if (overlap is not None and not overlap) or \
            (overlap is None and not _OVERLAP_DEFAULT):
        return "off"
    if P < 2:
        return "geometry"
    if not _cm._kernels_available():
        return "no_interpret"
    if pp_plan(n, d, dtype, P) is None:
        return "vmem_miss"
    return None


def relay_engages(n: int, d: int, dtype, P: int,
                  overlap: Optional[bool] = None) -> bool:
    """:func:`relay_engage_reason` collapsed to a bool."""
    return relay_engage_reason(n, d, dtype, P, overlap) is None


# ---------------------------------------------------------------------------
# kernel 20: pp_relay_kernel (csrc/pipeline.cu)
# ---------------------------------------------------------------------------

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(P, n, d) or (P, L, n, d) -> (P, L, n*d) in an integer dtype of the
    same width, so that copies keep every bit (NaN payloads included)."""
    P = x.shape[0]
    L = x.shape[1] if x.dim() == 4 else 1
    return x.reshape(P, L, -1).view(_BITS[x.element_size()])


def plain_relay(f: torch.Tensor, b: torch.Tensor, C: int,
                seg_elems: int):
    """f, b (P, n, d) or (P, L, n, d) -> (fo, bo) with ``fo[r] = f[r-1]``
    and ``bo[r] = b[r+1]`` (ranks modulo P), copied lane by lane in C
    segments of ``seg_elems`` elements, channel 0 then channel 1 in each,
    the kernel's units of work."""
    fo, bo = torch.empty_like(f), torch.empty_like(b)
    src = {0: _lanes(f), 1: _lanes(b)}
    dst = {0: _lanes(fo), 1: _lanes(bo)}
    E = src[0].shape[2]
    for c in range(C):
        lo, hi = c * seg_elems, min((c + 1) * seg_elems, E)
        for chan, shift in ((0, 1), (1, -1)):
            dst[chan][:, :, lo:hi] = torch.roll(src[chan][:, :, lo:hi],
                                                shift, 0)
    return fo, bo


def relay(f: torch.Tensor, b: torch.Tensor, plan: dict):
    """Kernel 20 (replaces ``pipeline_relay.py:_relay_kernel``). Same
    contract as :func:`plain_relay`, segments from :func:`pp_plan`; any
    dtype (the kernel moves bytes)."""
    if f.device.type != "cuda":
        return plain_relay(f, b, plan["C"], plan["seg_elems"])
    if f.shape != b.shape or f.dtype != b.dtype or f.device != b.device:
        raise ValueError(f"pp_relay_kernel: payloads must match, got "
                         f"{tuple(f.shape)}/{f.dtype} and "
                         f"{tuple(b.shape)}/{b.dtype}")
    if not (f.is_contiguous() and b.is_contiguous()):
        raise ValueError("pp_relay_kernel: payloads must be contiguous")
    if f.dim() not in (3, 4):
        raise ValueError(f"pp_relay_kernel: expects (P, n, d) or (P, L, n, "
                         f"d) payloads, got {tuple(f.shape)}")
    P = f.shape[0]
    L = f.shape[1] if f.dim() == 4 else 1
    if P > _MAX_RANKS:
        raise ValueError(f"pp_relay_kernel: at most {_MAX_RANKS} stages, "
                         f"got {P}")
    item = f.element_size()
    lane_elems = f.shape[-2] * f.shape[-1]
    C, seg = plan["C"], plan["seg_elems"]
    if C * seg < lane_elems or (C - 1) * seg >= lane_elems:
        raise ValueError(f"pp_relay_kernel: plan C {C} x {seg} does not "
                         f"cover {lane_elems} elements")
    fo, bo = torch.empty_like(f), torch.empty_like(b)
    lib = cuda_build.load("pipeline")
    rows = [t.view(P, -1) for t in (f, b, fo, bo)]
    with torch.cuda.device(f.device):
        rc = lib.accl_pipeline_relay(
            *(cuda_build.pointer_table(t) for t in rows), P, L,
            lane_elems * item, seg * item, C,
            cuda_build.stream_handle(f.device))
    cuda_build.check(lib, rc, "pp_relay_kernel")
    relay.launches += 1
    return fo, bo


relay.launches = 0


# ---------------------------------------------------------------------------
# the public op (differentiable; the roll pair counted as the fallback)
# ---------------------------------------------------------------------------

def _roll_relay(f: torch.Tensor, b: torch.Tensor):
    """The unfused pair (the JAX package's two ``ppermute``s): ``f`` one
    stage forward, ``b`` one stage back, along the leading stage axis."""
    return torch.roll(f, 1, 0), torch.roll(b, -1, 0)


def _relay_impl(f: torch.Tensor, b: torch.Tensor, overlap: Optional[bool]):
    if f.shape != b.shape or f.dtype != b.dtype:
        raise ValueError(
            f"pp_relay payloads must match: fwd {tuple(f.shape)}/{f.dtype} "
            f"vs bwd {tuple(b.shape)}/{b.dtype}")
    if f.dim() not in (3, 4):
        raise ValueError(f"pp_relay expects (P, n, d) or (P, L, n, d) "
                         f"payloads, got {tuple(f.shape)}")
    P, n, d = f.shape[0], f.shape[-2], f.shape[-1]
    reason = relay_engage_reason(n, d, f.dtype, P, overlap)
    if reason is None:
        _metrics.inc("accl_pp_relay_total", labels=(("path", "fused"),))
        return relay(f.contiguous(), b.contiguous(),
                     pp_plan(n, d, f.dtype, P))
    if reason != "off":
        _cm._note_fallback(PP_OP, reason)
    _metrics.inc("accl_pp_relay_total", labels=(("path", "ppermute"),))
    return _roll_relay(f, b)


class _PPRelay(torch.autograd.Function):
    """The relay and its backward, the same relay with the channels swapped
    (the JAX package's ``_relay_fwd``/``_relay_bwd``)."""

    @staticmethod
    def forward(ctx, f, b, overlap):
        ctx.overlap = overlap
        return _relay_impl(f, b, overlap)

    @staticmethod
    def backward(ctx, gf, gb):
        d_b, d_f = _relay_impl(gb.contiguous(), gf.contiguous(), ctx.overlap)
        return d_f, d_b, None


def pp_relay(fwd: torch.Tensor, bwd: torch.Tensor,
             overlap: Optional[bool] = None):
    """One pipeline tick's relay: ``fwd`` (P, n, d) or (P, L, n, d) shifts
    +1 stage (stage r's activation to stage r+1), ``bwd`` -1 (the
    gradient's reverse hop), both in one launch of the relay kernel when
    the plan engages, the roll pair otherwise (counted unless requested).
    ``overlap=None`` follows ``ACCLConfig.pp_overlap``. Differentiable."""
    return _PPRelay.apply(fwd, bwd, overlap)
