"""Collective matmul: the tensor-parallel all-gather x matmul and matmul x
reduce-scatter (counterpart: ``accl_tpu/ops/collective_matmul.py``), with
their backward.

Tensors carry every rank as a row of their first axis:

* :func:`all_gather_matmul`: x (P, m, k), each rank's row shard of the LHS;
  w (P, k, n), each rank's weight block (column-parallel). Returns (P, P*m,
  n) f32: ``all_gather(x, rows) @ w``.
* :func:`matmul_reduce_scatter`: x (P, m, k), each rank's rows (m divisible
  by P); w (P, k, n) (row-parallel). Returns (P, m/P, n) f32:
  ``reduce_scatter(x @ w, rows)``.

Both are ``torch.autograd.Function``s and each other's duals, as the JAX
package's ``custom_vjp``s are: dx of the all-gather x matmul is the matmul x
reduce-scatter of dy against w transposed and back, and the other way
round; dw of either is :func:`gathered_wgrad_body`, the all-gather of the
travelling operand folded into dw's contraction over rows. ``overlap``,
``bidirectional`` and ``wire_dtype`` pass through to every backward body.

Three kernels, each with a plain PyTorch version, a launch counter and a
wrapper that runs the plain version on CPU tensors and launches the CUDA
kernel on CUDA tensors (or raises; there is no fallback):

* :func:`agmm` replaces ``collective_matmul.py:_agmm_kernel`` and
  ``_agmm_stream_kernel``. Kernel: ``csrc/cmatmul.cu:agmm_kernel``.
* :func:`mmrs` replaces ``collective_matmul.py:_mmrs_kernel`` and
  ``_mmrs_stream_kernel``: the travelling accumulator folds the ranks'
  partials in the ring's order and rounds to the wire dtype before each
  hop. Kernel: ``csrc/cmatmul.cu:mmrs_kernel``.
* :func:`wgrad` replaces ``collective_matmul.py:_wgrad_kernel``: each
  rank's dw sums the gathered shards' partials in the ring's order (the
  local shard's two row halves, then each hop's arrivals). Kernel:
  ``csrc/cmatmul.cu:wgrad_kernel``.

The policy is the JAX package's, number for number: the session registers
(``ACCLConfig.cmatmul_overlap``, ``ag/rs_matmul_threshold``, the per-aspect
class thresholds, ``cmatmul_nblock``, ``cmatmul_wire_dtype``), the plans
:func:`agmm_plan`, :func:`mmrs_plan` and :func:`wgrad_plan` with their
resident, streaming and accumulator-blocking arms, the engage-reason
vocabulary (``off``, ``no_interpret``, ``threshold``, ``vmem_miss``,
``geometry``) and the counted fallbacks to the unfused pair
(``accl_cmatmul_fallback_total{op, reason}``, the backward's dw under
``{op}_dw``). The plans keep the TPU's VMEM budget, which the card's
kernels do not need, so that engage decisions, fallback labels and launch
counts equal the JAX package's; the streaming plan's ``nmb`` row blocks
(agmm), ``nnb`` column blocks (mmrs) and ``nctb`` traveller column blocks
(wgrad) are one kernel launch each.

Also here, shared with the fused all-to-all ops
(:mod:`.collective_alltoall`): the wire-dtype register and its resolution,
the wire staging cast (``_wire_cast``, over the plugin cast and
stochastic-rounding kernels of :mod:`.compression`) and ``_note_fallback``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import cuda_build
from ..constants import ACCLError, errorCode
from ..obs import metrics as _metrics

#: the JAX package's scoped-VMEM budget for the overlap plans (a TPU's
#: 16 MiB less Mosaic's margin). The card's kernels keep their operands in
#: device memory and need no such budget; the plans keep it so that they
#: decide what the JAX package decides.
_VMEM_BUDGET = 12 << 20
#: the TPU's lane width, the plans' column and k alignment
_LANES = 128


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _sublane(dtype) -> int:
    """The TPU's sublane tiling of a dtype (rows per tile)."""
    return 16 if _itemsize(dtype) == 2 else 8


# ---------------------------------------------------------------------------
# session registers (ACCLConfig write-through); per-call overrides on the
# entry points
# ---------------------------------------------------------------------------

_OVERLAP_DEFAULT = True
#: engage-at-or-above payload bytes of the ``overlap=None`` resolution: agmm
#: keys on the (m, k) LHS shard, mmrs on the (m/P, n) f32 travelling
#: accumulator, both in wire bytes; 0 until a session installs its values.
#: An explicit ``overlap=True`` bypasses them.
_AG_THRESHOLD = 0
_RS_THRESHOLD = 0
#: per-aspect-class overrides of the two registers, keyed by
#: :func:`aspect_class`; a class with no entry takes the scalar register
_AG_CLASS_THRESHOLDS: dict = {}
_RS_CLASS_THRESHOLDS: dict = {}
#: accumulator blocking (``ACCLConfig.cmatmul_nblock``): when even the
#: 128-lane k-block misses the budget, split the accumulator into blocks
#: (agmm: traveller rows, mmrs: output columns; wgrad's streaming arm:
#: traveller columns), one launch each; False declines such shapes
#: (``vmem_miss``)
_NBLOCK_DEFAULT = True


def set_overlap_enabled(enabled: bool) -> None:
    """Module default of the fused path (``ACCLConfig.cmatmul_overlap``
    lands here at every config assignment)."""
    global _OVERLAP_DEFAULT
    _OVERLAP_DEFAULT = bool(enabled)


def get_overlap_enabled() -> bool:
    return _OVERLAP_DEFAULT


def set_overlap_thresholds(ag_bytes: int, rs_bytes: int) -> None:
    """The session's fused-vs-unfused size registers (``ACCLConfig.
    ag_matmul_threshold`` / ``rs_matmul_threshold``)."""
    global _AG_THRESHOLD, _RS_THRESHOLD
    _AG_THRESHOLD = int(ag_bytes)
    _RS_THRESHOLD = int(rs_bytes)


def get_overlap_thresholds() -> Tuple[int, int]:
    return _AG_THRESHOLD, _RS_THRESHOLD


def aspect_class(k: int, n: int) -> str:
    """Aspect class of the (k, n) weight block: ``wide`` when n >= 2k,
    ``tall`` when k >= 2n, else ``square``."""
    if n >= 2 * k:
        return "wide"
    if k >= 2 * n:
        return "tall"
    return "square"


def set_overlap_class_thresholds(ag: dict, rs: dict) -> None:
    """The per-aspect-class registers (``ACCLConfig.ag/rs_matmul_class_
    thresholds``), keyed by :func:`aspect_class` names."""
    global _AG_CLASS_THRESHOLDS, _RS_CLASS_THRESHOLDS
    _AG_CLASS_THRESHOLDS = dict(ag or {})
    _RS_CLASS_THRESHOLDS = dict(rs or {})


def get_overlap_class_thresholds() -> Tuple[dict, dict]:
    return dict(_AG_CLASS_THRESHOLDS), dict(_RS_CLASS_THRESHOLDS)


def _ag_threshold(k: int, n: int) -> int:
    return int(_AG_CLASS_THRESHOLDS.get(aspect_class(k, n), _AG_THRESHOLD))


def _rs_threshold(k: int, n: int) -> int:
    return int(_RS_CLASS_THRESHOLDS.get(aspect_class(k, n), _RS_THRESHOLD))


def set_nblock_enabled(enabled: bool) -> None:
    """Module default of accumulator blocking (``ACCLConfig.
    cmatmul_nblock``)."""
    global _NBLOCK_DEFAULT
    _NBLOCK_DEFAULT = bool(enabled)


def get_nblock_enabled() -> bool:
    return _NBLOCK_DEFAULT


# ---------------------------------------------------------------------------
# wire staging (compress on the wire, accumulate wide)
# ---------------------------------------------------------------------------

#: session wire-dtype register (``ACCLConfig.cmatmul_wire_dtype``
#: write-through). None = the wire rides the operand dtype.
_WIRE_DTYPE_DEFAULT: Optional[str] = None

_WIRE_NAMES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "float16": torch.float16,
}

#: stochastic-rounding wire codecs: the same wire dtype, but the input
#: cast runs the stochastic-rounding kernel; in-kernel stagings (the
#: combine's y blocks) round to nearest even
_SR_WIRE_NAMES = {"bf16_sr": torch.bfloat16, "bfloat16_sr": torch.bfloat16}

_ALL_WIRE_NAMES = {**_WIRE_NAMES, **_SR_WIRE_NAMES}


def set_wire_dtype(name) -> None:
    """Set the session wire dtype (config write-through). None disables
    compression; the ``wire_dtype`` argument of every entry point overrides
    it per call (``"off"`` forces full precision)."""
    global _WIRE_DTYPE_DEFAULT
    if name is not None and name not in _ALL_WIRE_NAMES:
        raise ValueError(f"unsupported cmatmul wire dtype {name!r}; one of "
                         f"{sorted(_ALL_WIRE_NAMES)} or None")
    _WIRE_DTYPE_DEFAULT = name


def get_wire_dtype() -> Optional[str]:
    return _WIRE_DTYPE_DEFAULT


def _resolve_wire_codec(wire_dtype, operand_dtype):
    """A per-call wire request against the session register ->
    ``(torch dtype | None, stochastic)``; None is a full-precision wire.
    ``None`` follows the session default, ``"off"``/``False`` force full
    precision, the ``*_sr`` names select the stochastic-rounding cast. A
    wire at least as wide as the operand resolves to None (nothing to
    compress)."""
    w = _WIRE_DTYPE_DEFAULT if wire_dtype is None else wire_dtype
    if w is None or w is False or w == "off":
        return None, False
    sr = False
    if isinstance(w, str):
        if w not in _ALL_WIRE_NAMES:
            raise ValueError(f"unsupported cmatmul wire dtype {w!r}; one of "
                             f"{sorted(_ALL_WIRE_NAMES)}, 'off', or None")
        wdt = _ALL_WIRE_NAMES[w]
        sr = w in _SR_WIRE_NAMES
    else:
        wdt = w
    if _itemsize(wdt) >= _itemsize(operand_dtype):
        return None, False
    return wdt, sr


def _resolve_wire(wire_dtype, operand_dtype):
    """The dtype of :func:`_resolve_wire_codec` (plans and engage checks
    size staged terms and never care how the cast rounds)."""
    return _resolve_wire_codec(wire_dtype, operand_dtype)[0]


def wire_itemsize(dtype, wire_dtype=None) -> int:
    """Effective bytes per element on the wire under a wire request (the
    session default at None): what the size thresholds see."""
    wdt = _resolve_wire(wire_dtype, dtype)
    return _itemsize(wdt if wdt is not None else dtype)


def _wire_cast(x: torch.Tensor, wdt, stochastic: bool = False):
    """Stage a ``(world, ...)`` operand in the wire dtype through the plugin
    lane (the cast kernel on the card); identity when no compression
    resolved. ``stochastic`` takes the stochastic-rounding lane, seeded per
    rank with the wrapping int32 sum of that rank's payload bits (the JAX
    package's per-execution seed, which sees every bit flip)."""
    if wdt is None or x.dtype == wdt:
        return x
    from . import compression
    if stochastic:
        seeds = compression.payload_seed_base(x.reshape(x.shape[0], -1))
        return compression.pallas_compress_stochastic(
            x.contiguous(), wdt, seed=seeds)
    return compression.pallas_cast(x.contiguous(), wdt)


# ---------------------------------------------------------------------------
# fallback accounting
# ---------------------------------------------------------------------------

#: (op, reason) pairs already warned about; the counter counts every one
_warned_fallback: set = set()


def reset_fallback_warnings() -> None:
    _warned_fallback.clear()


def _note_fallback(op: str, reason: str) -> None:
    """One fused-path fallback: bump ``accl_cmatmul_fallback_total{op,
    reason}`` (``vmem_miss``: no plan geometry; ``no_interpret``: no
    backend runs the kernels; ``threshold``: the session size register
    declined) and warn once per (op, reason)."""
    _metrics.inc("accl_cmatmul_fallback_total",
                 labels=(("op", op), ("reason", reason)))
    if (op, reason) not in _warned_fallback:
        _warned_fallback.add((op, reason))
        from ..utils.logging import get_logger
        get_logger("collective_matmul").warning(
            "collective matmul %s: fused kernel fallback (%s); running the "
            "unfused pair", op, reason)


def _kernels_available() -> bool:
    """Whether the fused kernels can run. The JAX package needs a TPU or
    its interpreter; the port runs them wherever it runs, the CUDA kernels
    on the card and their plain versions on the CPU, so this is True and
    the ``no_interpret`` reason stays in the vocabulary for a backend that
    lacks them."""
    return True


def _dirs(chan: int, left: int, right: int, bidirectional: bool):
    """Per-channel ring orientation: (downstream, upstream, index sign).
    Channel 1 of a bidirectional ring rotates left."""
    if bidirectional and chan == 1:
        return left, right, 1
    return right, left, -1


# ---------------------------------------------------------------------------
# block-geometry policy (the JAX plans, number for number)
# ---------------------------------------------------------------------------

def _pad_to(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _shrink_block(bp: int, mult: int, fits) -> Optional[int]:
    """Largest ``mult``-aligned block (halving sweep from ``bp``) accepted
    by ``fits``; None when even one ``mult`` misses."""
    b = bp
    while b > mult and not fits(b):
        b = max(mult, _pad_to(b // 2, mult))
    return b if fits(b) else None


def _shrink_kb(kp: int, fits) -> Optional[int]:
    """Largest lane-aligned k-block (halving sweep from the padded k)
    accepted by ``fits``; None when even 128 lanes miss."""
    return _shrink_block(kp, _LANES, fits)


def agmm_plan(m: int, k: int, n: int, P: int, dtype,
              bidirectional: bool, w_dtype=None,
              wire_dtype=None) -> Optional[dict]:
    """Geometry of the fused all-gather x matmul: ``mode: resident`` when
    the shard, weight block, (P, m, n) f32 output panel and receive slots
    fit the budget together; ``mode: stream`` with ``kb``-column k-blocks
    when a k-block does; the accumulator-blocking arm (``mb``/``nmb``
    traveller row blocks) when even the 128-lane k-block misses; None when
    the lane-floor weight block alone misses. ``wire_dtype`` sizes the
    staged x terms, ``w_dtype`` the weight terms. On the card ``nchan``
    picks the hop order of the row halves and ``mb`` the launches."""
    if m < 1 or k < 1 or n < 1 or P < 1:
        return None
    xdt = wire_dtype if wire_dtype is not None else dtype
    isz = _itemsize(xdt)
    wisz = _itemsize(w_dtype) if w_dtype is not None else _itemsize(dtype)
    sub = _sublane(xdt)
    nchan = 2 if (bidirectional and P >= 4) else 1
    mp = _pad_to(max(m, 1), sub * nchan)
    kp = _pad_to(max(k, 1), _LANES)
    np_ = _pad_to(max(n, 1), _LANES)
    est = (mp * kp * isz            # x shard
           + kp * np_ * wisz        # w block
           + P * mp * np_ * 4       # f32 output blocks
           + 2 * mp * kp * isz)     # recv slots
    if est <= _VMEM_BUDGET:
        return {"mode": "resident", "mp": mp, "kp": kp, "np": np_,
                "nchan": nchan, "bidirectional": nchan == 2,
                "kb": kp, "nkb": 1, "vmem_bytes": est}

    def est_stream(kb):
        return (4 * mp * kb * isz      # 2 send + 2 recv slots
                + 2 * mp * np_ * 4     # double-buffered f32 accumulators
                + kb * np_ * wisz)     # staged w k-block

    kb = _shrink_kb(kp, lambda b: est_stream(b) <= _VMEM_BUDGET)
    if kb is not None:
        nkb = -(-kp // kb)
        return {"mode": "stream", "mp": mp, "kp": nkb * kb, "np": np_,
                "nchan": nchan, "bidirectional": nchan == 2,
                "kb": kb, "nkb": nkb, "vmem_bytes": est_stream(kb)}
    if not _NBLOCK_DEFAULT:
        return None

    def est_block(mb, kb):
        return (4 * mb * kb * isz
                + 2 * mb * np_ * 4
                + kb * np_ * wisz)

    mb = _shrink_block(mp, sub * nchan,
                       lambda b: est_block(b, _LANES) <= _VMEM_BUDGET)
    if mb is None:
        return None
    kb = _shrink_kb(kp, lambda b: est_block(mb, b) <= _VMEM_BUDGET)
    nmb = -(-mp // mb)
    nkb = -(-kp // kb)
    return {"mode": "stream", "mp": nmb * mb, "kp": nkb * kb, "np": np_,
            "nchan": nchan, "bidirectional": nchan == 2,
            "kb": kb, "nkb": nkb, "mb": mb, "nmb": nmb,
            "vmem_bytes": est_block(mb, kb)}


def mmrs_plan(m: int, k: int, n: int, P: int, dtype,
              bidirectional: bool, w_dtype=None,
              wire_dtype=None) -> Optional[dict]:
    """Geometry of the fused matmul x reduce-scatter; ``m`` is the full
    local row count (None unless it divides by P). ``mode: resident`` when
    the chunk grid, weight block and travelling accumulator fit;
    ``mode: stream`` with ``kb`` k-blocks; the accumulator-blocking arm
    (``nb``/``nnb`` column blocks) when even the 128-lane k-block misses.
    ``wire_dtype`` sizes the travelling accumulator's wire terms. On the
    card ``cp // nchan`` is the row where channel 1 starts and ``nb`` the
    launches."""
    if m < 1 or k < 1 or n < 1 or P < 1 or m % P:
        return None
    isz = _itemsize(dtype)
    acc_wisz = _itemsize(wire_dtype) if wire_dtype is not None else 4
    wisz = _itemsize(w_dtype) if w_dtype is not None else isz
    sub = _sublane(dtype)
    nchan = 2 if (bidirectional and P >= 4) else 1
    cp = _pad_to(max(m // P, 1), sub * nchan)
    kp = _pad_to(max(k, 1), _LANES)
    np_ = _pad_to(max(n, 1), _LANES)
    wire_extra = cp * np_ * acc_wisz if wire_dtype is not None else 0
    est = (P * cp * kp * isz        # x grouped by chunk
           + kp * np_ * wisz        # w block
           + cp * np_ * 4           # f32 output chunk
           + cp * np_ * 4           # acc
           + 2 * cp * np_ * acc_wisz  # recv slots (wire dtype)
           + wire_extra)            # wire staging buffer
    if est <= _VMEM_BUDGET:
        return {"mode": "resident", "cp": cp, "kp": kp, "np": np_,
                "nchan": nchan, "bidirectional": nchan == 2,
                "kb": kp, "nkb": 1, "vmem_bytes": est}

    def est_stream(kb):
        return (cp * np_ * 4                # f32 output chunk
                + cp * np_ * 4              # acc
                + cp * np_ * 4              # per-hop partial
                + 2 * cp * np_ * acc_wisz   # recv slots
                + wire_extra                # wire staging buffer
                + (cp // nchan) * kb * isz  # streamed x block
                + kb * np_ * wisz)          # streamed w block

    kb = _shrink_kb(kp, lambda b: est_stream(b) <= _VMEM_BUDGET)
    if kb is not None:
        nkb = -(-kp // kb)
        return {"mode": "stream", "cp": cp, "kp": nkb * kb, "np": np_,
                "nchan": nchan, "bidirectional": nchan == 2,
                "kb": kb, "nkb": nkb, "vmem_bytes": est_stream(kb)}
    if not _NBLOCK_DEFAULT:
        return None

    def est_block(nb, kb):
        wx = cp * nb * acc_wisz if wire_dtype is not None else 0
        return (3 * cp * nb * 4
                + 2 * cp * nb * acc_wisz
                + wx
                + (cp // nchan) * kb * isz
                + kb * nb * wisz)

    nb = _shrink_block(np_, _LANES,
                       lambda b: est_block(b, _LANES) <= _VMEM_BUDGET)
    if nb is None:
        return None
    kb = _shrink_kb(kp, lambda b: est_block(nb, b) <= _VMEM_BUDGET)
    nkb = -(-kp // kb)
    nnb = -(-np_ // nb)
    return {"mode": "stream", "cp": cp, "kp": nkb * kb, "np": nnb * nb,
            "nchan": nchan, "bidirectional": nchan == 2,
            "kb": kb, "nkb": nkb, "nb": nb, "nnb": nnb,
            "vmem_bytes": est_block(nb, kb)}


def wgrad_plan(ms: int, ct: int, cl: int, P: int, trav_dtype, loc_dtype,
               bidirectional: bool) -> Optional[dict]:
    """Geometry of the fused gathered wgrad: resident when the travelling
    (ms, ct) shard, its two receive slots, the local (ms, cl) block and the
    f32 (ct, cl) dw panel fit the budget together; else the streaming arm
    (``cmatmul_nblock``) splits the traveller's columns into ``ctb`` blocks
    (keys ``ctb``/``nctb``), one launch each into a disjoint dw block;
    None when even the 128-lane block misses. The rows are the contraction
    and split in ``nchan`` halves: on the card ``msp // nchan`` is the row
    where channel 1 starts."""
    if ms < 1 or ct < 1 or cl < 1 or P < 1:
        return None
    tisz = _itemsize(trav_dtype)
    lisz = _itemsize(loc_dtype)
    sub = max(_sublane(trav_dtype), _sublane(loc_dtype))
    nchan = 2 if (bidirectional and P >= 4) else 1
    msp = _pad_to(max(ms, 1), sub * nchan)
    ctp = _pad_to(max(ct, 1), _LANES)
    clp = _pad_to(max(cl, 1), _LANES)
    est = (msp * ctp * tisz          # own travelling shard
           + 2 * msp * ctp * tisz    # recv slots
           + msp * clp * lisz        # per-channel local blocks
           + ctp * clp * 4)          # f32 dw accumulator
    if est <= _VMEM_BUDGET:
        return {"msp": msp, "ctp": ctp, "clp": clp, "nchan": nchan,
                "bidirectional": nchan == 2, "vmem_bytes": est}
    if not _NBLOCK_DEFAULT:
        return None

    def est_block(ctb):
        return (3 * msp * ctb * tisz   # trav block + recv slots
                + msp * clp * lisz     # per-channel local blocks
                + ctb * clp * 4)       # f32 dw block accumulator

    ctb = _shrink_block(ctp, _LANES, lambda b: est_block(b) <= _VMEM_BUDGET)
    if ctb is None:
        return None
    nctb = -(-ctp // ctb)
    return {"msp": msp, "ctp": nctb * ctb, "clp": clp, "nchan": nchan,
            "bidirectional": nchan == 2, "ctb": ctb, "nctb": nctb,
            "vmem_bytes": est_block(ctb)}


# ---------------------------------------------------------------------------
# the unfused pair (the fallback, and the baseline)
# ---------------------------------------------------------------------------

def xla_all_gather_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The sequential pair: the all-gather of the row shards, then each
    rank's matmul in f32."""
    P, m, k = x.shape
    return torch.matmul(x.reshape(1, P * m, k).float(), w.float())


def xla_matmul_reduce_scatter(x: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """The sequential pair: each rank's full matmul in f32, then the
    reduce-scatter over the row chunks."""
    P, m, _ = x.shape
    y = torch.matmul(x.float(), w.float())
    return y.view(P, P, m // P, w.shape[2]).sum(0)


# ---------------------------------------------------------------------------
# kernels 12/14 and 13/15: agmm_kernel, mmrs_kernel (csrc/cmatmul.cu)
# ---------------------------------------------------------------------------

_DT_CODE = {torch.float16: 2, torch.float32: 3, torch.bfloat16: 7}
#: the wire dtype codes of mmrs_kernel (0: no wire)
_WIRE_CODE = {None: 0, torch.float16: 2, torch.bfloat16: 7}


def _operand_codes(what: str, x: torch.Tensor, w: torch.Tensor,
                   out: torch.Tensor):
    for t in (x, w, out):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{what}: operands must be contiguous on one "
                             f"device")
    if x.shape[0] > 64:
        raise ValueError(f"{what}: at most 64 ranks, got {x.shape[0]}")
    codes = [_DT_CODE.get(t.dtype) for t in (x, w)]
    if None in codes or out.dtype != torch.float32:
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"{what} takes f32, bf16 or f16 operands and an f32 "
                        f"output, got {x.dtype}, {w.dtype} -> {out.dtype}")
    return codes


def plain_agmm(x: torch.Tensor, w: torch.Tensor, out=None, rows=None,
               half=None) -> torch.Tensor:
    """x (P, m, k), w (P, k, n) -> out (P, P*m, n) f32 with ``out[r, s*m +
    i] = x[s, i] @ w[r]`` for the shard rows i in ``rows`` (default all),
    products of the operands' f32 values. ``half`` (the first row of
    channel 1) orders the kernel's hops and not the result."""
    P, m, k = x.shape
    n = w.shape[2]
    r0, r1 = rows if rows is not None else (0, m)
    if out is None:
        out = torch.empty((P, P * m, n), dtype=torch.float32,
                          device=x.device)
    blk = torch.matmul(x[:, r0:r1].float().reshape(1, P * (r1 - r0), k),
                       w.float())
    out.view(P, P, m, n)[:, :, r0:r1] = blk.view(P, P, r1 - r0, n)
    return out


def agmm(x: torch.Tensor, w: torch.Tensor, out=None, rows=None,
         half=None) -> torch.Tensor:
    """Kernels 12 and 14 (replace ``collective_matmul.py:_agmm_kernel`` and
    ``_agmm_stream_kernel``). Same contract as :func:`plain_agmm`; ``half``
    is the first row of channel 1 (the second half of a bidirectional
    ring's block), which orders the hops and not the result."""
    if x.device.type != "cuda":
        return plain_agmm(x, w, out, rows, half)
    P, m, k = x.shape
    n = w.shape[2]
    if tuple(w.shape) != (P, k, n):
        raise ValueError(f"agmm_kernel: w {tuple(w.shape)} does not match "
                         f"x {tuple(x.shape)}")
    r0, r1 = rows if rows is not None else (0, m)
    half = r1 if half is None else half
    if out is None:
        out = torch.empty((P, P * m, n), dtype=torch.float32,
                          device=x.device)
    codes = _operand_codes("agmm_kernel", x, w, out)
    lib = cuda_build.load("cmatmul")
    with torch.cuda.device(x.device):
        rc = lib.accl_cmatmul_agmm(
            *codes, cuda_build.pointer_table(x), cuda_build.pointer_table(w),
            cuda_build.pointer_table(out), P, m, k, n, r0, r1, half,
            cuda_build.stream_handle(x.device))
    cuda_build.check(lib, rc, "agmm_kernel")
    agmm.launches += 1
    return out


agmm.launches = 0


def plain_mmrs(x: torch.Tensor, w: torch.Tensor, out=None, cols=None,
               split=None, wire=None) -> torch.Tensor:
    """x (P, P*mc, k), w (P, k, n) -> out (P, mc, n) f32, chunk r of
    ``reduce_scatter(x @ w)`` for the columns in ``cols`` (default all):
    the partials ``x[q, r*mc + i] @ w[q]`` folded in the ring's order, rows
    below ``split`` (default mc) ranks r, r+1, ..., r-1 (channel 0), the
    rest r, r-1, ..., r+1 (channel 1); before each fold the travelling sum
    is rounded to ``wire`` (round to nearest even) and the add is f32."""
    P, m, k = x.shape
    mc, n = m // P, w.shape[2]
    c0, c1 = cols if cols is not None else (0, n)
    split = mc if split is None else split
    if out is None:
        out = torch.empty((P, mc, n), dtype=torch.float32, device=x.device)
    part = torch.matmul(x.float(), w[:, :, c0:c1].float()) \
        .view(P, P, mc, c1 - c0)                        # [q, chunk, i, j]
    ranks = torch.arange(P, device=x.device)
    for chan, (lo, hi) in enumerate(((0, split), (split, mc))):
        if lo >= hi:
            continue
        sign = _dirs(chan, 0, 0, bidirectional=True)[2]
        acc = part[ranks, ranks, lo:hi]
        for t in range(1, P):
            q = (ranks - sign * t) % P
            if wire is not None:
                acc = acc.to(wire).float()
            acc = acc + part[q, ranks, lo:hi]
        out[:, lo:hi, c0:c1] = acc
    return out


def mmrs(x: torch.Tensor, w: torch.Tensor, out=None, cols=None, split=None,
         wire=None) -> torch.Tensor:
    """Kernels 13 and 15 (replace ``collective_matmul.py:_mmrs_kernel`` and
    ``_mmrs_stream_kernel``). Same contract as :func:`plain_mmrs`."""
    if x.device.type != "cuda":
        return plain_mmrs(x, w, out, cols, split, wire)
    P, m, k = x.shape
    n = w.shape[2]
    if tuple(w.shape) != (P, k, n) or m % P:
        raise ValueError(f"mmrs_kernel: w {tuple(w.shape)} does not match "
                         f"x {tuple(x.shape)}")
    mc = m // P
    c0, c1 = cols if cols is not None else (0, n)
    split = mc if split is None else split
    if wire not in _WIRE_CODE:
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"mmrs_kernel: unsupported wire dtype {wire}")
    if out is None:
        out = torch.empty((P, mc, n), dtype=torch.float32, device=x.device)
    codes = _operand_codes("mmrs_kernel", x, w, out)
    lib = cuda_build.load("cmatmul")
    with torch.cuda.device(x.device):
        rc = lib.accl_cmatmul_mmrs(
            *codes, _WIRE_CODE[wire], cuda_build.pointer_table(x),
            cuda_build.pointer_table(w), cuda_build.pointer_table(out), P,
            mc, k, n, c0, c1, split, cuda_build.stream_handle(x.device))
    cuda_build.check(lib, rc, "mmrs_kernel")
    mmrs.launches += 1
    return out


mmrs.launches = 0


# ---------------------------------------------------------------------------
# kernel 16: wgrad_kernel (csrc/cmatmul.cu)
# ---------------------------------------------------------------------------

def _wgrad_segments(P: int, ms: int, split: int):
    """The sum order of :func:`wgrad`: ``(offset of the source rank, row
    range)`` pairs, the local shard's channel-0 rows, then its channel-1
    rows (from ``split``), then hop by hop channel 0's arrival from rank r -
    t and channel 1's from rank r + t (``_wgrad_kernel``'s ring)."""
    segs = []
    for t in range(P):
        segs.append((-t, (0, split)))
        if split < ms:
            segs.append((t, (split, ms)))
    return segs


def plain_wgrad(trav: torch.Tensor, loc: torch.Tensor, out=None, cols=None,
                split=None, travel_lhs: bool = True) -> torch.Tensor:
    """trav (P, ms, ct) each rank's shard of the gathered operand, loc (P,
    P*ms, cl) each rank's resident operand, row block s pairing with rank
    s's shard -> out (P, ct, cl) f32 with ``out[r] = all_gather(trav)ᵀ @
    loc[r]`` (``travel_lhs``) or (P, cl, ct) with ``locᵀ @ all_gather``,
    for the traveller's columns in ``cols`` (default all): each segment's
    partial of the operands' f32 values, the partials summed in the order
    of :func:`_wgrad_segments` (rows below ``split``, default ms, are
    channel 0)."""
    P, ms, ct = trav.shape
    cl = loc.shape[2]
    c0, c1 = cols if cols is not None else (0, ct)
    split = ms if split is None else split
    if out is None:
        out = torch.empty((P, ct, cl) if travel_lhs else (P, cl, ct),
                          dtype=torch.float32, device=trav.device)
    t = trav[:, :, c0:c1].float()
    lb = loc.float().view(P, P, ms, cl)                  # [r, src, i, j]
    ranks = torch.arange(P, device=trav.device)
    acc = None
    for off, (lo, hi) in _wgrad_segments(P, ms, split):
        src = (ranks + off) % P
        a, b = t[src, lo:hi], lb[ranks, src, lo:hi]
        part = a.transpose(1, 2) @ b if travel_lhs else b.transpose(1, 2) @ a
        acc = part if acc is None else acc + part
    if travel_lhs:
        out[:, c0:c1] = acc
    else:
        out[:, :, c0:c1] = acc
    return out


def wgrad(trav: torch.Tensor, loc: torch.Tensor, out=None, cols=None,
          split=None, travel_lhs: bool = True) -> torch.Tensor:
    """Kernel 16 (replaces ``collective_matmul.py:_wgrad_kernel``). Same
    contract as :func:`plain_wgrad`; one launch per column block of the
    traveller (the streaming plan's ``ctb``)."""
    if trav.device.type != "cuda":
        return plain_wgrad(trav, loc, out, cols, split, travel_lhs)
    P, ms, ct = trav.shape
    cl = loc.shape[2]
    if tuple(loc.shape) != (P, P * ms, cl):
        raise ValueError(f"wgrad_kernel: loc {tuple(loc.shape)} does not "
                         f"match trav {tuple(trav.shape)}")
    c0, c1 = cols if cols is not None else (0, ct)
    split = ms if split is None else split
    if out is None:
        out = torch.empty((P, ct, cl) if travel_lhs else (P, cl, ct),
                          dtype=torch.float32, device=trav.device)
    codes = _operand_codes("wgrad_kernel", trav, loc, out)
    lib = cuda_build.load("cmatmul")
    with torch.cuda.device(trav.device):
        rc = lib.accl_cmatmul_wgrad(
            *codes, int(travel_lhs), cuda_build.pointer_table(trav),
            cuda_build.pointer_table(loc), cuda_build.pointer_table(out), P,
            ms, ct, cl, c0, c1, split, cuda_build.stream_handle(trav.device))
    cuda_build.check(lib, rc, "wgrad_kernel")
    wgrad.launches += 1
    return out


wgrad.launches = 0


# ---------------------------------------------------------------------------
# engage policy
# ---------------------------------------------------------------------------

def _resolve(overlap: Optional[bool], nbytes: int, threshold: int) -> bool:
    """overlap=None: the session default and the payload clears the size
    register; True/False: forced. Either way the kernels must run here."""
    if overlap is None:
        on = _OVERLAP_DEFAULT and nbytes >= threshold
    else:
        on = bool(overlap)
    return on and _kernels_available()


def agmm_engage_reason(m: int, k: int, n: int, P: int, dtype,
                       overlap: Optional[bool] = None,
                       bidirectional: bool = True,
                       wire_dtype=None, w_dtype=None) -> Optional[str]:
    """None when :func:`all_gather_matmul` would run the fused kernel for
    these per-rank shapes under the given overlap mode, else the decline
    reason: ``"off"`` (a requested baseline, never counted),
    ``"no_interpret"``, ``"threshold"`` or ``"vmem_miss"``."""
    wdt = _resolve_wire(wire_dtype, dtype)
    nbytes = m * k * _itemsize(wdt if wdt is not None else dtype)
    if (overlap is not None and not overlap) or \
            (overlap is None and not _OVERLAP_DEFAULT):
        return "off"
    if not _kernels_available():
        return "no_interpret"
    if overlap is None and nbytes < _ag_threshold(k, n):
        return "threshold"
    if agmm_plan(m, k, n, P, dtype, bidirectional,
                 w_dtype=w_dtype, wire_dtype=wdt) is None:
        return "vmem_miss"
    return None


def agmm_engages(m: int, k: int, n: int, P: int, dtype,
                 overlap: Optional[bool] = None,
                 bidirectional: bool = True,
                 wire_dtype=None, w_dtype=None) -> bool:
    """:func:`agmm_engage_reason` as a bool."""
    return agmm_engage_reason(m, k, n, P, dtype, overlap, bidirectional,
                              wire_dtype, w_dtype) is None


def mmrs_engage_reason(m: int, k: int, n: int, P: int, dtype,
                       overlap: Optional[bool] = None,
                       bidirectional: bool = True,
                       wire_dtype=None, w_dtype=None) -> Optional[str]:
    """:func:`agmm_engage_reason`'s sibling for
    :func:`matmul_reduce_scatter` (the traveller is the f32 accumulator,
    so wire bytes key off f32); rows not divisible by the world report
    ``"geometry"``."""
    if P < 1 or m % P:
        return "geometry"
    wdt = _resolve_wire(wire_dtype, torch.float32)
    nbytes = (m // P) * n * (_itemsize(wdt) if wdt is not None else 4)
    if (overlap is not None and not overlap) or \
            (overlap is None and not _OVERLAP_DEFAULT):
        return "off"
    if not _kernels_available():
        return "no_interpret"
    if overlap is None and nbytes < _rs_threshold(k, n):
        return "threshold"
    if mmrs_plan(m, k, n, P, dtype, bidirectional,
                 w_dtype=w_dtype, wire_dtype=wdt) is None:
        return "vmem_miss"
    return None


def mmrs_engages(m: int, k: int, n: int, P: int, dtype,
                 overlap: Optional[bool] = None,
                 bidirectional: bool = True,
                 wire_dtype=None, w_dtype=None) -> bool:
    """:func:`mmrs_engage_reason` as a bool."""
    return mmrs_engage_reason(m, k, n, P, dtype, overlap, bidirectional,
                              wire_dtype, w_dtype) is None


def wgrad_engage_reason(ms: int, ct: int, cl: int, P: int, dtype,
                        overlap: Optional[bool] = None,
                        bidirectional: bool = True,
                        wire_dtype=None, loc_dtype=None,
                        travel_lhs: bool = True) -> Optional[str]:
    """:func:`agmm_engage_reason`'s sibling for :func:`gathered_wgrad_body`:
    the travelling (ms, ct) shard's wire bytes against the forward op's
    register (``travel_lhs`` keys the agmm table, else the mmrs one) and
    :func:`wgrad_plan`; worlds below 2 report ``"geometry"``."""
    if P < 2:
        return "geometry"
    wdt = _resolve_wire(wire_dtype, dtype)
    nbytes = ms * ct * _itemsize(wdt if wdt is not None else dtype)
    if (overlap is not None and not overlap) or \
            (overlap is None and not _OVERLAP_DEFAULT):
        return "off"
    if not _kernels_available():
        return "no_interpret"
    th = _ag_threshold(ct, cl) if travel_lhs else _rs_threshold(cl, ct)
    if overlap is None and nbytes < th:
        return "threshold"
    if wgrad_plan(ms, ct, cl, P, wdt if wdt is not None else dtype,
                  loc_dtype if loc_dtype is not None else dtype,
                  bidirectional) is None:
        return "vmem_miss"
    return None


def _fallback_reason(overlap: Optional[bool], op: str) -> None:
    """Count a policy-level fallback; an explicit or session overlap-off is
    a requested baseline, never counted."""
    if overlap is not None and not overlap:
        return
    if overlap is None and not _OVERLAP_DEFAULT:
        return
    _note_fallback(op, "no_interpret" if not _kernels_available()
                   else "threshold")


# ---------------------------------------------------------------------------
# bodies (shape checks and policy around the kernels)
# ---------------------------------------------------------------------------

def _check_pair(x: torch.Tensor, w: torch.Tensor):
    P, m, k = x.shape
    P2, k2, n = w.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape[1:])} vs "
                         f"w {tuple(w.shape[1:])}")
    if P2 != P:
        raise ValueError(f"x has {P} rank rows, w has {P2}")
    return P, m, k, n


def all_gather_matmul_body(x: torch.Tensor, w: torch.Tensor, *,
                           overlap: Optional[bool] = None,
                           bidirectional: bool = True, wire_dtype=None):
    """x (P, m, k) row shards, w (P, k, n) -> (P, P*m, n) f32. The plan
    picks the resident or the streaming geometry (the same kernel here,
    once per ``mb`` row block); the unfused pair runs on a declined
    threshold or a plan miss, each counted by reason. ``wire_dtype``
    stages the shards in a narrower dtype (f32 accumulation); the fallback
    runs full precision."""
    P, m, k, n = _check_pair(x, w)
    if P == 1:
        return torch.matmul(x.float(), w.float())
    wdt, sr = _resolve_wire_codec(wire_dtype, x.dtype)
    shard_bytes = m * k * _itemsize(wdt if wdt is not None else x.dtype)
    plan = None
    if _resolve(overlap, shard_bytes, _ag_threshold(k, n)):
        plan = agmm_plan(m, k, n, P, x.dtype, bidirectional,
                         w_dtype=w.dtype, wire_dtype=wdt)
        if plan is None:
            _note_fallback("allgather_matmul", "vmem_miss")
    else:
        _fallback_reason(overlap, "allgather_matmul")
    if plan is None:
        return xla_all_gather_matmul(x, w)
    xw = _wire_cast(x, wdt, stochastic=sr).contiguous()
    w = w.contiguous()
    mb = plan.get("mb", plan["mp"])
    out = torch.empty((P, P * m, n), dtype=torch.float32, device=x.device)
    for i in range(plan.get("nmb", 1)):
        # one launch per traveller row block, each with its own channel
        # split (the TPU body runs one streaming kernel per block)
        r0, r1 = i * mb, min((i + 1) * mb, m)
        agmm(xw, w, out, (r0, r1), min(r0 + mb // plan["nchan"], r1))
    return out


def matmul_reduce_scatter_body(x: torch.Tensor, w: torch.Tensor, *,
                               overlap: Optional[bool] = None,
                               bidirectional: bool = True, wire_dtype=None):
    """x (P, m, k) local rows, w (P, k, n) -> (P, m/P, n) f32, rank r
    holding chunk r. ``wire_dtype`` rounds the travelling accumulator
    before each hop (the folds add in f32); the fallback runs full
    precision."""
    P, m, k, n = _check_pair(x, w)
    if m % P:
        raise ValueError(f"rows {m} not divisible by world {P}")
    if P == 1:
        return torch.matmul(x.float(), w.float())
    wdt = _resolve_wire(wire_dtype, torch.float32)
    acc_bytes = (m // P) * n * (_itemsize(wdt) if wdt is not None else 4)
    plan = None
    if _resolve(overlap, acc_bytes, _rs_threshold(k, n)):
        plan = mmrs_plan(m, k, n, P, x.dtype, bidirectional,
                         w_dtype=w.dtype, wire_dtype=wdt)
        if plan is None:
            _note_fallback("matmul_reduce_scatter", "vmem_miss")
    else:
        _fallback_reason(overlap, "matmul_reduce_scatter")
    if plan is None:
        return xla_matmul_reduce_scatter(x, w)
    mc = m // P
    # the channels split the PADDED chunk: with a ragged mc the halves
    # fold in opposite orders
    split = min(plan["cp"] // plan["nchan"], mc)
    x, w = x.contiguous(), w.contiguous()
    nb = plan.get("nb", plan["np"])
    out = torch.empty((P, mc, n), dtype=torch.float32, device=x.device)
    for j in range(plan.get("nnb", 1)):
        # one launch per column block of the travelling accumulator
        mmrs(x, w, out, (j * nb, min((j + 1) * nb, n)), split, wdt)
    return out


def gathered_wgrad_body(trav: torch.Tensor, loc: torch.Tensor, *,
                        overlap: Optional[bool] = None,
                        bidirectional: bool = True, wire_dtype=None,
                        travel_lhs: bool = True,
                        op: str = "allgather_matmul"):
    """The fused dw of both backward passes: trav (P, ms, ct) each rank's
    shard of the operand the backward must gather (x for d(ag x mm), dy for
    d(mm x rs)), loc (P, P*ms, cl) each rank's resident operand, whose row
    block s pairs with rank s's shard. ``travel_lhs=True`` returns (P, ct,
    cl) f32, ``all_gather(trav)ᵀ @ loc``; False returns (P, cl, ct), ``locᵀ
    @ all_gather(trav)``. The kernel folds the gather into the contraction
    (one launch per ``ctb`` column block of the traveller on the streaming
    arm); the unfused gather and product run where the plan misses or the
    policy declines, counted under ``{op}_dw``. ``wire_dtype`` stages the
    traveller; the fallback runs full precision."""
    P, ms, ct = trav.shape
    P2, ml, cl = loc.shape
    if ml != P * ms:
        raise ValueError(
            f"wgrad row mismatch: loc rows {ml} != world {P} x shard {ms}")
    if P2 != P:
        raise ValueError(f"trav has {P} rank rows, loc has {P2}")

    def _unfused(gathered):
        # every rank's rows concatenated; the JAX body casts the second
        # operand to the first's dtype, then contracts in f32
        a, b = (gathered, loc) if travel_lhs else (loc, gathered)
        return torch.matmul(a.transpose(-2, -1).float(),
                            b.to(a.dtype).float())

    if P == 1:
        return _unfused(trav)
    wdt, sr = _resolve_wire_codec(wire_dtype, trav.dtype)
    nbytes = ms * ct * _itemsize(wdt if wdt is not None else trav.dtype)
    # the traveller keys on its forward op's register
    th = _ag_threshold(ct, cl) if travel_lhs else _rs_threshold(cl, ct)
    plan = None
    if _resolve(overlap, nbytes, th):
        plan = wgrad_plan(ms, ct, cl, P,
                          wdt if wdt is not None else trav.dtype, loc.dtype,
                          bidirectional)
        if plan is None:
            _note_fallback(op + "_dw", "vmem_miss")
    else:
        _fallback_reason(overlap, op + "_dw")
    if plan is None:
        return _unfused(trav.reshape(1, P * ms, ct))
    tw = _wire_cast(trav, wdt, stochastic=sr).contiguous()
    loc = loc.contiguous()
    # the channels split the PADDED rows: channel 1 starts at msp / 2
    split = min(plan["msp"] // plan["nchan"], ms)
    ctb = plan.get("ctb", plan["ctp"])
    out = torch.empty((P, ct, cl) if travel_lhs else (P, cl, ct),
                      dtype=torch.float32, device=trav.device)
    for j in range(plan.get("nctb", 1)):
        # one launch per column block of the traveller, each into a
        # disjoint block of dw
        wgrad(tw, loc, out, (j * ctb, min((j + 1) * ctb, ct)), split,
              travel_lhs)
    return out


# ---------------------------------------------------------------------------
# entry points: the collective-matmul duality as autograd Functions
# ---------------------------------------------------------------------------

class _AllGatherMatmul(torch.autograd.Function):
    """``all_gather_matmul``'s forward and backward (the JAX package's
    ``_agmm_fwd``/``_agmm_bwd``): dx = the row shard of ``dy @ wᵀ``
    summed over the ranks, which is the matmul x reduce-scatter; dw =
    ``all_gather(x)ᵀ @ dy``, the gathered wgrad. A gradient no input needs
    is not computed."""

    @staticmethod
    def forward(ctx, x, w, overlap, bidirectional, wire_dtype):
        ctx.save_for_backward(x, w)
        ctx.opts = {"overlap": overlap, "bidirectional": bidirectional,
                    "wire_dtype": wire_dtype}
        return all_gather_matmul_body(x, w, **ctx.opts)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = matmul_reduce_scatter_body(
                dy.to(x.dtype), w.transpose(1, 2).to(x.dtype),
                **ctx.opts).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gathered_wgrad_body(
                x, dy.to(x.dtype), travel_lhs=True, op="allgather_matmul",
                **ctx.opts).to(w.dtype)
        return dx, dw, None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    """``matmul_reduce_scatter``'s forward and backward (``_mmrs_fwd``/
    ``_mmrs_bwd``): dx = ``all_gather(dy) @ wᵀ``, the all-gather x
    matmul; dw = ``xᵀ @ all_gather(dy)``, the gathered wgrad with dy
    travelling."""

    @staticmethod
    def forward(ctx, x, w, overlap, bidirectional, wire_dtype):
        ctx.save_for_backward(x, w)
        ctx.opts = {"overlap": overlap, "bidirectional": bidirectional,
                    "wire_dtype": wire_dtype}
        return matmul_reduce_scatter_body(x, w, **ctx.opts)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = all_gather_matmul_body(
                dy.to(x.dtype), w.transpose(1, 2).to(x.dtype),
                **ctx.opts).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gathered_wgrad_body(
                dy.to(x.dtype), x, travel_lhs=False,
                op="matmul_reduce_scatter", **ctx.opts).to(w.dtype)
        return dx, dw, None, None, None


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor,
                      overlap: Optional[bool] = None,
                      bidirectional: bool = True, wire_dtype=None):
    """``all_gather(x, rows) @ w``: x (P, m, k) row shards, w (P, k, n)
    column-parallel weight blocks, out (P, P*m, n) f32. ``overlap=None``
    follows the session default and size registers; False pins the
    unfused pair. ``wire_dtype=None`` follows ``ACCLConfig.
    cmatmul_wire_dtype`` ("off" forces full precision). Differentiable:
    the backward runs the dual matmul x reduce-scatter for dx and the
    gathered wgrad for dw."""
    return _AllGatherMatmul.apply(x, w, overlap, bidirectional, wire_dtype)


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor,
                          overlap: Optional[bool] = None,
                          bidirectional: bool = True, wire_dtype=None):
    """``reduce_scatter(x @ w, rows)``: x (P, m, k) local rows (m divisible
    by P), w (P, k, n) row-parallel weight blocks, out (P, m/P, n) f32.
    Same policy as :func:`all_gather_matmul`. Differentiable: dx runs the
    dual all-gather x matmul, dw the gathered wgrad of dy."""
    return _MatmulReduceScatter.apply(x, w, overlap, bidirectional,
                                      wire_dtype)
