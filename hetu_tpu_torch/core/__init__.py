from .device import (Device, DeviceGroup, DeviceGroupUnion, DeviceType,
                     global_device_group, local_device, resolve_device)
from .dtype import (DataType, bfloat16, bool_, canonicalize_dtype, float4,
                    float16, float32, float64, int8, int16, int32, int64,
                    nfloat4, torch_dtype, uint8)

__all__ = ["DataType", "Device", "DeviceGroup", "DeviceGroupUnion",
           "DeviceType", "bfloat16", "bool_", "canonicalize_dtype", "float4",
           "float16", "float32", "float64", "global_device_group", "int8",
           "int16", "int32", "int64", "local_device", "nfloat4",
           "resolve_device", "torch_dtype", "uint8"]
