"""Wire-cast lanes, the ``hp_compression`` plugin (counterpart:
``accl_tpu/ops/compression.py``).

Two kernels, each with a plain PyTorch version, a launch counter and a
wrapper that runs the plain version on CPU tensors and launches the CUDA
kernel on CUDA tensors (or raises; there is no fallback). The names are the
JAX package's, so each counterpart is easy to find; on the card they launch
the kernels of ``csrc/plugins.cu``:

* :func:`pallas_cast` replaces ``compression.py:_cast_kernel``: the
  ``CAST_PAIRS`` casts, round to nearest even with overflow to infinity
  when narrowing, exact when widening. A NaN takes XLA's bit pattern (a
  quiet NaN of the same sign: bf16 0x7FC0/0xFFC0, f16 0x7E00/0xFE00 for
  a quiet f32 NaN), which neither torch's ``.to()`` on the CPU nor the
  card's convert instruction gives, so both the kernel and
  :func:`plain_cast` set NaN by bits. Kernel: ``cast_kernel``.
* :func:`pallas_compress_stochastic` replaces ``compression.py:_sr_kernel``:
  f32 -> bf16 with stochastic rounding. For finite x the result is the top
  16 bits of ``bits(x) + (h & 0xFFFF)``, ``h`` a 32-bit counter-based hash
  of (seed, element index), so every output is one of x's two bf16
  neighbours and rounds up with probability equal to the dropped fraction;
  +-inf stays, NaN is the cast's. The TPU kernel draws its bits from the
  core's PRNG seeded with (seed, grid position); the element index takes
  the grid position's part. Its bits are not the TPU's, so it agrees with
  the JAX package in distribution, not bit for bit (off the TPU the JAX
  package degrades to the deterministic cast). Kernel: ``sr_kernel``.

Both kernels are bound by device memory bandwidth: they read each input
once and write each output once.
"""
from __future__ import annotations

from typing import Union

import torch

from .. import constants, cuda_build
from ..constants import ACCLError, dataType, errorCode, to_torch_dtype

#: supported (src, dst) cast lanes
CAST_PAIRS = (
    (dataType.float32, dataType.bfloat16),
    (dataType.bfloat16, dataType.float32),
    (dataType.float32, dataType.float16),
    (dataType.float16, dataType.float32),
)

_M32 = 0xFFFFFFFF


def _i16(bits: torch.Tensor) -> torch.Tensor:
    """int32/int64 values in [0, 65536) as the int16 of the same bits."""
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)


# ---------------------------------------------------------------------------
# kernel 2: wire casts (_cast_kernel)
# ---------------------------------------------------------------------------

def plain_cast(x: torch.Tensor, dst: torch.dtype) -> torch.Tensor:
    """``x.to(dst)`` with the JAX lane's NaN bit patterns: narrowing f32
    NaN -> bf16 sign|0x7FC0, f16 sign|0x7E00|(mantissa >> 13); widening
    f16 NaN -> sign|0x7FC00000|(mantissa << 13), bf16 NaN ->
    sign|0x7FC00000."""
    y = x.to(dst)
    if not x.is_floating_point() or x.dtype == dst:
        return y
    nan = torch.isnan(x)
    if x.dtype == torch.float32 and dst in (torch.bfloat16, torch.float16):
        u = x.view(torch.int32).to(torch.int64) & _M32
        sign = (u >> 16) & 0x8000
        bits = sign | 0x7FC0 if dst == torch.bfloat16 else \
            sign | 0x7E00 | ((u & 0x7FFFFF) >> 13)
        return torch.where(nan, _i16(bits), y.view(torch.int16)).view(dst)
    if dst == torch.float32 and x.dtype in (torch.float16, torch.bfloat16):
        h = x.view(torch.int16).to(torch.int64) & 0xFFFF
        bits = ((h & 0x8000) << 16) | 0x7FC00000
        if x.dtype == torch.float16:
            bits = bits | ((h & 0x3FF) << 13)
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
        return torch.where(nan, bits.to(torch.int32),
                           y.view(torch.int32)).view(dst)
    return y


def pallas_cast(x: torch.Tensor, dst_dtype: torch.dtype) -> torch.Tensor:
    """Kernel 2 (replaces ``compression.py:_cast_kernel``): ``x`` in
    ``dst_dtype``, any shape, for the ``CAST_PAIRS`` lanes. On a CUDA tensor
    it launches ``csrc/plugins.cu:cast_kernel``; another pair raises
    ``KERNEL_NOT_REGISTERED`` there."""
    if x.device.type != "cuda":
        return plain_cast(x, dst_dtype)
    pair = (constants.from_torch_dtype(x.dtype),
            constants.from_torch_dtype(dst_dtype))
    if pair not in CAST_PAIRS:
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"cast_kernel has no {x.dtype} -> {dst_dtype} lane")
    if not x.is_contiguous():
        raise ValueError("cast_kernel: input must be contiguous")
    out = torch.empty(x.shape, dtype=dst_dtype, device=x.device)
    lib = cuda_build.load("plugins")
    with torch.cuda.device(x.device):
        rc = lib.accl_plugins_cast(int(pair[0]), int(pair[1]), x.data_ptr(),
                                   out.data_ptr(), x.numel(),
                                   cuda_build.stream_handle(x.device))
    cuda_build.check(lib, rc, "cast_kernel")
    pallas_cast.launches += 1
    return out


pallas_cast.launches = 0


def make_cast(src: dataType, dst: dataType):
    """Registry-compatible cast impl for one (src, dst) lane."""
    dst_t = to_torch_dtype(dst)

    def impl(x):
        return pallas_cast(x, dst_t)

    impl.__name__ = f"pallas_cast_{src.name}_to_{dst.name}"
    return impl


# ---------------------------------------------------------------------------
# seeds and the hash, in 32-bit unsigned arithmetic on Python ints or int64
# tensors (values in [0, 2**32))
# ---------------------------------------------------------------------------

def _mul32(a, c: int):
    """(a * c) mod 2**32 without overflowing int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _signed32(h):
    if isinstance(h, torch.Tensor):
        return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)
    return h - (1 << 32) if h >= 1 << 31 else h


def derive_seed(base, step: int):
    """Per-step seed for multi-leg schedules: a splitmix-style integer mix
    of ``(base seed, step index)``, bit-equal to the JAX package's. ``base``
    is a Python int or an integer tensor (one seed per element); the result
    is a signed 32-bit value of the same kind (an int32 tensor)."""
    if isinstance(base, torch.Tensor):
        h = base.to(torch.int64) & _M32
    else:
        h = int(base) & _M32
    h = h ^ ((int(step) * 0x9E3779B9 + 0x7F4A7C15) & _M32)
    return _signed32(_fmix32(h))


def payload_seed_base(x: torch.Tensor) -> torch.Tensor:
    """Per-row int32 sum (wrapping) of the float32 bits of ``x`` (rows,
    cols): the seed base the two-tier schedules derive from a payload,
    ``jnp.sum(bitcast(x, int32), dtype=int32)`` in the JAX package."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return _signed32(bits.sum(dim=-1, dtype=torch.int64) & _M32)


# ---------------------------------------------------------------------------
# kernel 3: stochastic rounding f32 -> bf16 (_sr_kernel)
# ---------------------------------------------------------------------------

def _seed_rows(x: torch.Tensor, seed):
    """(seeds as a tensor of R int32 seeds or an int, R): x is taken as
    (R, numel // R), one seed per row."""
    if isinstance(seed, torch.Tensor) and seed.numel() > 1:
        rows = seed.numel()
        if x.numel() % rows:
            raise ValueError(f"{rows} seeds do not split {tuple(x.shape)} "
                             f"into rows")
        return seed.reshape(rows).to(torch.int32), rows
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(torch.int32), 1
    return int(seed), 1


def plain_compress_stochastic(x: torch.Tensor, seed=0) -> torch.Tensor:
    """The stochastic round of :func:`pallas_compress_stochastic` in torch
    int64 arithmetic masked to 32 bits."""
    seeds, rows = _seed_rows(x, seed)
    x2 = x.reshape(rows, -1)
    u = x2.view(torch.int32).to(torch.int64) & _M32
    if isinstance(seeds, torch.Tensor):
        key = _fmix32(seeds.to(x.device).to(torch.int64).reshape(rows, 1)
                      & _M32)
    else:
        key = _fmix32(seeds & _M32)
    idx = torch.arange(x2.shape[1], dtype=torch.int64, device=x.device)
    h = _fmix32(_mul32(idx, 0x9E3779B9) ^ key)
    bits = (u + (h & 0xFFFF)) >> 16
    bits = torch.where(torch.isnan(x2), ((u >> 16) & 0x8000) | 0x7FC0, bits)
    return _i16(bits).view(torch.bfloat16).reshape(x.shape)


def pallas_compress_stochastic(x: torch.Tensor, dst_dtype=torch.bfloat16,
                               seed: Union[int, torch.Tensor] = 0
                               ) -> torch.Tensor:
    """Kernel 3 (replaces ``compression.py:_sr_kernel``): f32 -> bf16 with
    stochastic rounding. ``seed`` is an int, a one-element tensor, or a
    tensor of R seeds that takes ``x`` as R rows (the ranks of a
    ``(world, n)`` payload), each hashed with its own seed and its own
    element index. On a CUDA tensor it launches
    ``csrc/plugins.cu:sr_kernel`` (a seed tensor stays on the card)."""
    if dst_dtype != torch.bfloat16 or x.dtype != torch.float32:
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"sr_kernel rounds float32 to bfloat16 only, got "
                        f"{x.dtype} -> {dst_dtype}")
    if x.device.type != "cuda":
        return plain_compress_stochastic(x, seed)
    if not x.is_contiguous():
        raise ValueError("sr_kernel: input must be contiguous")
    seeds, rows = _seed_rows(x, seed)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    ptr, scalar = 0, 0
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.to(x.device).contiguous()
        ptr = seeds.data_ptr()
    else:
        scalar = _signed32(seeds & _M32)
    lib = cuda_build.load("plugins")
    with torch.cuda.device(x.device):
        rc = lib.accl_plugins_sr(x.data_ptr(), out.data_ptr(), ptr, scalar,
                                 rows, x.numel() // rows,
                                 cuda_build.stream_handle(x.device))
    cuda_build.check(lib, rc, "sr_kernel")
    pallas_compress_stochastic.launches += 1
    return out


pallas_compress_stochastic.launches = 0
