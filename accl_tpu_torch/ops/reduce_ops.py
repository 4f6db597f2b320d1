"""Elementwise reduction lane, the ``reduce_ops`` plugin (counterpart:
``accl_tpu/ops/reduce_ops.py``).

:func:`pallas_combine` replaces ``reduce_ops.py:_combine_kernel``: a ⊕ b,
SUM or MAX, for the ``PALLAS_DTYPES``. It keeps the JAX package's name so
its counterpart is easy to find; on a CUDA tensor it launches
``csrc/plugins.cu:combine_kernel``, on a CPU tensor it runs
:func:`plain_combine`, and there is no fallback between the two. bf16 and
f16 SUM add in f32 and round once, as XLA does on the CPU; int32 SUM wraps;
MAX is IEEE-754 ``maximum`` (NaN propagates, +0 > -0). ``donate=True``
writes the result into operand ``a`` and returns it (the JAX package
aliases the output onto operand 0; chained combines rely on it).

The kernel is bound by device memory bandwidth: it reads both operands once
and writes the result once (3·n·itemsize bytes), with 16-byte vector
accesses.

f64 and i64 have no lane here, as they have none in the JAX package
(``PALLAS_DTYPES``): :func:`..parallel.primitives.build_combine` sends them
to the registry's plain combine on every device, which is the JAX
package's own routing, not a fallback. The kernel refuses them.
"""
from __future__ import annotations

import torch

from .. import constants, cuda_build
from ..constants import ACCLError, dataType, errorCode, reduceFunction
from .compression import plain_cast
from .registry import maximum

#: dtypes with a combine lane (f64/i64 take the registry's plain combine)
PALLAS_DTYPES = (dataType.float32, dataType.bfloat16, dataType.float16,
                 dataType.int32)


def plain_combine(a: torch.Tensor, b: torch.Tensor,
                  func: reduceFunction) -> torch.Tensor:
    """a ⊕ b with the kernel's arithmetic."""
    if func == reduceFunction.MAX:
        return maximum(a, b)
    if func != reduceFunction.SUM:
        raise ValueError(f"unsupported reduce function {func}")
    if a.dtype in (torch.bfloat16, torch.float16):
        return plain_cast(a.float() + b.float(), a.dtype)
    return a + b


def pallas_combine(a: torch.Tensor, b: torch.Tensor, func: reduceFunction,
                   *, donate: bool = False) -> torch.Tensor:
    """Kernel 1 (replaces ``reduce_ops.py:_combine_kernel``): a ⊕ b for
    operands of one shape and dtype."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"combine operands differ: {tuple(a.shape)} "
                         f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.device.type != "cuda":
        out = plain_combine(a, b, func)
        return a.copy_(out) if donate else out
    dt = constants.from_torch_dtype(a.dtype)
    if dt not in PALLAS_DTYPES:
        raise ACCLError(errorCode.KERNEL_NOT_REGISTERED,
                        f"combine_kernel has no {a.dtype} lane")
    if func not in (reduceFunction.SUM, reduceFunction.MAX):
        raise ValueError(f"unsupported reduce function {func}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("combine_kernel: operands must be contiguous")
    if b.device != a.device:
        raise ValueError("combine_kernel: operands on different devices")
    out = a if donate else torch.empty_like(a)
    lib = cuda_build.load("plugins")
    with torch.cuda.device(a.device):
        rc = lib.accl_plugins_combine(int(dt), int(func), a.data_ptr(),
                                      b.data_ptr(), out.data_ptr(),
                                      a.numel(),
                                      cuda_build.stream_handle(a.device))
    cuda_build.check(lib, rc, "combine_kernel")
    pallas_combine.launches += 1
    return out


pallas_combine.launches = 0


def make_combine(func: reduceFunction, dt: dataType):
    """Build a registry-compatible combine impl for one (function, dtype)
    lane."""

    def impl(a, b):
        return pallas_combine(a, b, func)

    impl.__name__ = f"pallas_{func.name.lower()}_{dt.name}"
    return impl
