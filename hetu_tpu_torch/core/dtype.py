"""Data types of the port (counterpart of ``hetu_tpu.core.dtype``).

``DataType`` names every storage type of the JAX package, the 4-bit
codebook formats (``float4``/``nfloat4``, packed two codes a byte)
included, and maps each onto the ``torch.dtype`` it is computed and
stored in (``to_torch``).  64-bit types narrow to 32 bits, as the JAX
package's do without x64; the 4-bit formats are stored as ``uint8``.
``torch_dtype`` takes a ``DataType``, a name or alias, a numpy dtype or
a ``torch.dtype``; an unknown name raises ``ValueError``.
"""
from __future__ import annotations

import enum
from typing import Union

import numpy as np
import torch


class DataType(enum.Enum):
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT16 = "float16"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BFLOAT16 = "bfloat16"
    BOOL = "bool"
    # 4-bit quantization codebook formats (packed storage, not compute types)
    FLOAT4 = "float4"
    NFLOAT4 = "nfloat4"

    @property
    def is_floating_point(self) -> bool:
        return self in (DataType.FLOAT16, DataType.FLOAT32, DataType.FLOAT64,
                        DataType.BFLOAT16, DataType.FLOAT4, DataType.NFLOAT4)

    @property
    def is_quantized(self) -> bool:
        return self in (DataType.FLOAT4, DataType.NFLOAT4)

    def to_torch(self) -> torch.dtype:
        """The ``torch.dtype`` the type is computed and stored in."""
        if self.is_quantized:
            return torch.uint8      # two packed codes a byte
        if self in _NARROW:
            return _NARROW[self]
        if self not in _TO_TORCH:
            raise ValueError(f"this torch has no {self.value}")
        return _TO_TORCH[self]

    @property
    def itemsize(self) -> float:
        """Bytes an element (half a byte for the 4-bit formats)."""
        if self.is_quantized:
            return 0.5
        return np.dtype(self.value).itemsize if self != DataType.BFLOAT16 \
            else 2


_TO_TORCH = {
    DataType.UINT8: torch.uint8,
    DataType.INT8: torch.int8,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT16: torch.float16,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.BOOL: torch.bool,
}
# torch has the wide unsigned types since 2.3
for _dt in (DataType.UINT16, DataType.UINT32, DataType.UINT64):
    if hasattr(torch, _dt.value):
        _TO_TORCH[_dt] = getattr(torch, _dt.value)
# 64-bit types narrow as in the JAX package without x64
_NARROW = {DataType.INT64: torch.int32, DataType.FLOAT64: torch.float32}

_FROM_STR = {dt.value: dt for dt in DataType}
_ALIASES = {
    "fp16": DataType.FLOAT16,
    "fp32": DataType.FLOAT32,
    "fp64": DataType.FLOAT64,
    "bf16": DataType.BFLOAT16,
    "half": DataType.FLOAT16,
    "float": DataType.FLOAT32,
    "double": DataType.FLOAT64,
    "fp4": DataType.FLOAT4,
    "nf4": DataType.NFLOAT4,
    "int": DataType.INT32,
    "long": DataType.INT64,
}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}

DTypeLike = Union[DataType, str, type, np.dtype, torch.dtype, None]


def canonicalize_dtype(dtype: DTypeLike) -> DataType:
    """A ``DataType`` for a ``DataType``, a name or alias, a numpy dtype
    or a ``torch.dtype`` (``None`` is float32)."""
    if dtype is None:
        return DataType.FLOAT32
    if isinstance(dtype, DataType):
        return dtype
    if isinstance(dtype, torch.dtype):
        if dtype in _FROM_TORCH:
            return _FROM_TORCH[dtype]
        raise ValueError(f"cannot canonicalize dtype: {dtype!r}")
    if isinstance(dtype, str):
        if dtype in _FROM_STR:
            return _FROM_STR[dtype]
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        raise ValueError(f"unknown dtype string: {dtype!r}")
    name = np.dtype(dtype).name
    if name in _FROM_STR:
        return _FROM_STR[name]
    raise ValueError(f"cannot canonicalize dtype: {dtype!r}")


def torch_dtype(dtype: DTypeLike) -> torch.dtype:
    """Any dtype-like -> the ``torch.dtype`` it is computed in."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return canonicalize_dtype(dtype).to_torch()


# module-level names, as ``hetu_tpu.float32`` etc.
uint8 = DataType.UINT8
int8 = DataType.INT8
int16 = DataType.INT16
int32 = DataType.INT32
int64 = DataType.INT64
float16 = DataType.FLOAT16
float32 = DataType.FLOAT32
float64 = DataType.FLOAT64
bfloat16 = DataType.BFLOAT16
bool_ = DataType.BOOL
float4 = DataType.FLOAT4
nfloat4 = DataType.NFLOAT4
