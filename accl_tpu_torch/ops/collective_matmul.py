"""Collective-matmul helpers (counterpart: ``accl_tpu/ops/collective_matmul.py``).

Only the part the fused all-to-all ops (:mod:`.collective_alltoall`) share
with the collective matmuls is ported so far: the session wire-dtype
register and its resolution (``get_wire_dtype``, ``_resolve_wire_codec``,
``_resolve_wire``), the wire staging cast (``_wire_cast``, over the plugin
cast and stochastic-rounding kernels of :mod:`.compression`), the counted
fallbacks (``_note_fallback``: ``accl_cmatmul_fallback_total{op, reason}``)
and ``_kernels_available``.

Still to port (ROADMAP.md queue 1, item 10): the all-gather x matmul and
matmul x reduce-scatter kernels (``_agmm_kernel``, ``_mmrs_kernel``, their
streaming variants and ``_wgrad_kernel``), their plans (``agmm_plan``,
``mmrs_plan``, ``wgrad_plan``), the overlap and threshold registers, and
the differentiable entry points.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..obs import metrics as _metrics

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
    itemsize = torch.empty((), dtype=wdt).element_size()
    if itemsize >= torch.empty((), dtype=operand_dtype).element_size():
        return None, False
    return wdt, sr


def _resolve_wire(wire_dtype, operand_dtype):
    """The dtype of :func:`_resolve_wire_codec` (plans and engage checks
    size staged terms and never care how the cast rounds)."""
    return _resolve_wire_codec(wire_dtype, operand_dtype)[0]


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
