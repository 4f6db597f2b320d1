"""PyTorch/CUDA port of ACCL-TPU (counterpart: ``accl_tpu/__init__.py``).

An MPI-like collective library whose ranks live on one device: rank ``r``
is row ``r`` of each buffer's ``(world, n)`` tensor. On the card the ring
collectives run hand-written CUDA kernels (``csrc/ring.cu``, built with
``nvcc`` at first use); on the CPU every program runs its plain PyTorch
version. Imports ``torch``, never ``jax`` and nothing of ``accl_tpu``.
"""
from .accl import ACCL
from .arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
from .buffer import Buffer
from .communicator import Communicator
from .config import ACCLConfig, Algorithm, TransportBackend
from .constants import (
    ACCLError,
    ACCLTimeoutError,
    compressionFlags,
    dataType,
    errorCode,
    operation,
    reduceFunction,
)
from .request import Request, requestStatus

__all__ = [
    "ACCL", "ACCLConfig", "ACCLError", "ACCLTimeoutError", "Algorithm",
    "ArithConfig", "Buffer", "Communicator", "DEFAULT_ARITH_CONFIG",
    "Request", "TransportBackend", "compressionFlags", "dataType",
    "errorCode", "operation", "reduceFunction", "requestStatus",
]
