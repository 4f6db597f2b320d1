"""Core enums, flags and error codes (counterpart: ``accl_tpu/constants.py``).

Same names and numeric values as the JAX package; the dtype map targets
``torch`` dtypes (:func:`to_torch_dtype`) in place of ``to_jax_dtype``, and
:func:`to_numpy_dtype` gives the host-mirror dtype (numpy has no bfloat16,
so bf16 buffers mirror as float32, which holds every bf16 value exactly).
"""
from __future__ import annotations

import enum

import numpy as np
import torch

#: eager vs rendezvous split (bytes)
DEFAULT_MAX_EAGER_SIZE = 32 * 1024
DEFAULT_MAX_RENDEZVOUS_SIZE = 1 << 30

#: segment size for chunked/pipelined collectives (bytes)
DEFAULT_SEGMENT_SIZE = 4 * 1024 * 1024


class operation(enum.IntEnum):
    """Collective scenario ids."""

    config = 0
    copy = 1
    combine = 2
    send = 3
    recv = 4
    bcast = 5
    scatter = 6
    gather = 7
    reduce = 8
    allgather = 9
    allreduce = 10
    reduce_scatter = 11
    barrier = 12
    alltoall = 13
    put = 14
    allgather_matmul = 15
    matmul_reduce_scatter = 16
    alltoall_matmul = 17
    matmul_alltoall = 18
    nop = 255


class reduceFunction(enum.IntEnum):
    SUM = 0
    MAX = 1


class dataType(enum.IntEnum):
    none = 0
    int8 = 1
    float16 = 2
    float32 = 3
    float64 = 4
    int32 = 5
    int64 = 6
    bfloat16 = 7


_DTYPE_TO_TORCH = {
    dataType.int8: torch.int8,
    dataType.float16: torch.float16,
    dataType.float32: torch.float32,
    dataType.float64: torch.float64,
    dataType.int32: torch.int32,
    dataType.int64: torch.int64,
    dataType.bfloat16: torch.bfloat16,
}

_TORCH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TORCH.items()}

_DTYPE_TO_NUMPY = {
    dataType.int8: np.int8,
    dataType.float16: np.float16,
    dataType.float32: np.float32,
    dataType.float64: np.float64,
    dataType.int32: np.int32,
    dataType.int64: np.int64,
    dataType.bfloat16: np.float32,
}

_DTYPE_SIZE = {
    dataType.int8: 1,
    dataType.float16: 2,
    dataType.bfloat16: 2,
    dataType.float32: 4,
    dataType.int32: 4,
    dataType.float64: 8,
    dataType.int64: 8,
}


def to_torch_dtype(dt: dataType) -> torch.dtype:
    return _DTYPE_TO_TORCH[dt]


def from_torch_dtype(dt: torch.dtype) -> dataType:
    return _TORCH_TO_DTYPE[dt]


def to_numpy_dtype(dt: dataType):
    """Host-mirror dtype of a buffer of ``dt`` (bf16 mirrors as float32)."""
    return _DTYPE_TO_NUMPY[dt]


def dtype_size(dt: dataType) -> int:
    return _DTYPE_SIZE[dt]


class errorCode(enum.IntFlag):
    """Per-call error bitmask (same bits as ``accl_tpu.constants``)."""

    COLLECTIVE_OP_SUCCESS = 0
    DMA_MISMATCH_ERROR = 1 << 0
    DMA_TRANSACTION_ERROR = 1 << 1
    DMA_BUTT_ERROR = 1 << 2
    RX_BUFFER_NOT_READY = 1 << 3
    INVALID_BUFFER_SIZE = 1 << 4
    COMPRESSION_ERROR = 1 << 5
    KERNEL_NOT_REGISTERED = 1 << 6
    RECEIVE_OFFSET_ERROR = 1 << 7
    COLLECTIVE_NOT_IMPLEMENTED = 1 << 8
    RECEIVE_OFFCHIP_ERROR = 1 << 9
    OPEN_PORT_NOT_SUCCEEDED = 1 << 10
    OPEN_CON_NOT_SUCCEEDED = 1 << 11
    DMA_SIZE_ERROR = 1 << 12
    ARITH_ERROR = 1 << 13
    PACK_TIMEOUT_STS_ERROR = 1 << 14
    PACK_SEQ_NUMBER_ERROR = 1 << 15
    COMPRESSION_NOT_SUPPORTED = 1 << 16
    KRNL_TIMEOUT_STS_ERROR = 1 << 17
    KRNL_STS_COUNT_ERROR = 1 << 18
    SEGMENTER_EXPECTED_BTT_ERROR = 1 << 19
    DMA_NOT_EXPECTED_BTT_ERROR = 1 << 20
    CONFIG_ERROR = 1 << 21
    NOT_READY_ERROR = 1 << 22
    TIMEOUT_ERROR = 1 << 23
    PEER_FAILED = 1 << 24
    COMM_INVALIDATED = 1 << 25


class compressionFlags(enum.IntFlag):
    """Per-operand compression flags; ``ETH_COMPRESSED`` = compress on the
    wire only."""

    NO_COMPRESSION = 0
    OP0_COMPRESSED = 1 << 0
    OP1_COMPRESSED = 1 << 1
    RES_COMPRESSED = 1 << 2
    ETH_COMPRESSED = 1 << 3


class ACCLError(Exception):
    """Raised when a call fails with a non-zero :class:`errorCode` bitmask."""

    def __init__(self, code: errorCode, context: str = ""):
        self.code = errorCode(code)
        names = [f.name for f in errorCode if f and f in self.code]
        msg = f"ACCL call failed ({context}): {'|'.join(names) or hex(code)}"
        super().__init__(msg)


class ACCLTimeoutError(ACCLError):
    def __init__(self, context: str = ""):
        super().__init__(errorCode.TIMEOUT_ERROR, context)
