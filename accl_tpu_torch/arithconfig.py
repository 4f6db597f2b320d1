"""Datapath dtype policy (counterpart: ``accl_tpu/arithconfig.py``).

For a pair of (uncompressed, compressed) datatypes: element widths, the
compression ratio, the supported reduce functions, whether reductions run
in the compressed dtype (``arith_is_compressed``, same-dtype pairs) or
decompress first (casting and quantized pairs), and the int8 wire's
``quant_scale`` (wire value = clip(round(x * quant_scale), -127, 127)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .constants import dataType, dtype_size, reduceFunction


@dataclasses.dataclass(frozen=True)
class ArithConfig:
    uncompressed: dataType
    compressed: dataType
    supported_functions: Tuple[reduceFunction, ...] = (
        reduceFunction.SUM,
        reduceFunction.MAX,
    )
    arith_is_compressed: bool = True
    quant_scale: Optional[float] = None

    @property
    def decompress_before_arith(self) -> bool:
        """True when reductions must run in the uncompressed dtype: the wire
        dtype is transport-only."""
        return self.is_compressing and not self.arith_is_compressed

    @property
    def uncompressed_bytes(self) -> int:
        return dtype_size(self.uncompressed)

    @property
    def compressed_bytes(self) -> int:
        return dtype_size(self.compressed)

    @property
    def ratio(self) -> float:
        return self.uncompressed_bytes / self.compressed_bytes

    @property
    def is_compressing(self) -> bool:
        return self.uncompressed != self.compressed

    def supports(self, fn: reduceFunction) -> bool:
        return fn in self.supported_functions


def _same(dt: dataType) -> ArithConfig:
    return ArithConfig(dt, dt, arith_is_compressed=True)


#: every supported dtype paired with itself, plus the f32 casting pairs
DEFAULT_ARITH_CONFIG: Dict[Tuple[dataType, dataType], ArithConfig] = {
    (dt, dt): _same(dt)
    for dt in (
        dataType.float16,
        dataType.bfloat16,
        dataType.float32,
        dataType.float64,
        dataType.int32,
        dataType.int64,
    )
}
DEFAULT_ARITH_CONFIG[(dataType.float32, dataType.float16)] = ArithConfig(
    dataType.float32, dataType.float16, arith_is_compressed=False
)
DEFAULT_ARITH_CONFIG[(dataType.float32, dataType.bfloat16)] = ArithConfig(
    dataType.float32, dataType.bfloat16, arith_is_compressed=False
)
