"""Devices of the port (counterpart of ``hetu_tpu.core.device``).

Every entry point (``Engine``, ``generate``, the graphs, the weight
converter) takes ``device=`` defaulting to ``"cuda"``.  A missing card
is an error, never a silent move to the CPU: the CPU is used only when
the caller names it (``resolve_device``).

``Device`` identifies one card (or the host CPU) by type, index and
host name and parses ``"cuda:0"``, ``"cpu"`` and ``"host1/cuda:1"``;
``DeviceGroup`` is an ordered set of devices and ``DeviceGroupUnion``
one group a (heterogeneous) pipeline slot, as in the JAX package.
``local_device`` and ``global_device_group`` read the cards
``torch.cuda`` sees.
"""
from __future__ import annotations

import enum
import functools
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import torch


class DeviceType(enum.Enum):
    CPU = "cpu"
    CUDA = "cuda"
    UNDETERMINED = "undetermined"


@dataclass(frozen=True, order=True)
class Device:
    """One device: type, index, host name and multiplex slot."""
    type: DeviceType = DeviceType.UNDETERMINED
    index: int = 0
    hostname: str = ""
    multiplex: int = 0

    @staticmethod
    def parse(spec: Union["Device", str]) -> "Device":
        """Parses ``"cpu"``, ``"cuda:3"`` or ``"host1/cuda:0"``."""
        if isinstance(spec, Device):
            return spec
        hostname, body = "", spec
        if "/" in spec:
            hostname, body = spec.split("/", 1)
        if ":" in body:
            type_str, idx_str = body.split(":", 1)
            index = int(idx_str)
        else:
            type_str, index = body, 0
        return Device(DeviceType(type_str.lower()), index, hostname)

    @property
    def is_cpu(self) -> bool:
        return self.type == DeviceType.CPU

    @property
    def is_cuda(self) -> bool:
        return self.type == DeviceType.CUDA

    def local(self) -> bool:
        return self.hostname in ("", "localhost")

    def __str__(self) -> str:
        prefix = f"{self.hostname}/" if self.hostname else ""
        return f"{prefix}{self.type.value}:{self.index}"


class DeviceGroup:
    """An ordered set of devices."""

    def __init__(self, devices: Iterable[Union[Device, str]] = ()):
        self._devices: Tuple[Device, ...] = tuple(Device.parse(d)
                                                  for d in devices)

    @property
    def devices(self) -> Tuple[Device, ...]:
        return self._devices

    @property
    def num_devices(self) -> int:
        return len(self._devices)

    def empty(self) -> bool:
        return not self._devices

    def contains(self, device: Union[Device, str]) -> bool:
        return Device.parse(device) in self._devices

    def get_index(self, device: Union[Device, str]) -> int:
        return self._devices.index(Device.parse(device))

    def get(self, index: int) -> Device:
        return self._devices[index]

    def __len__(self) -> int:
        return self.num_devices

    def __iter__(self):
        return iter(self._devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceGroup) and \
            self._devices == other._devices

    def __hash__(self) -> int:
        return hash(self._devices)

    def __repr__(self) -> str:
        return f"DeviceGroup([{', '.join(map(str, self._devices))}])"


class DeviceGroupUnion:
    """Device groups, one a (heterogeneous) pipeline slot."""

    def __init__(self, groups: Sequence[DeviceGroup]):
        self._groups: Tuple[DeviceGroup, ...] = tuple(groups)

    @property
    def groups(self) -> Tuple[DeviceGroup, ...]:
        return self._groups

    def size(self) -> int:
        return len(self._groups)

    def get(self, i: int) -> DeviceGroup:
        return self._groups[i]

    def all_devices(self) -> DeviceGroup:
        seen: List[Device] = []
        for g in self._groups:
            for d in g:
                if d not in seen:
                    seen.append(d)
        return DeviceGroup(seen)

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceGroupUnion) and \
            self._groups == other._groups

    def __hash__(self) -> int:
        return hash(self._groups)

    def __repr__(self) -> str:
        return f"DeviceGroupUnion({list(self._groups)!r})"


def local_device() -> Device:
    """The device this process computes on: its current card, or the CPU
    where ``torch.cuda`` sees none."""
    if torch.cuda.is_available():
        return Device(DeviceType.CUDA, torch.cuda.current_device())
    return Device(DeviceType.CPU, 0)


def global_device_group(device_type: Optional[DeviceType] = None
                        ) -> DeviceGroup:
    """Every card ``torch.cuda`` sees (``torch.cuda.device_count()``), or
    the CPU where it sees none, as an ordered group."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devs = [Device(DeviceType.CUDA, i) for i in range(n)] or \
        [Device(DeviceType.CPU, 0)]
    return DeviceGroup(d for d in devs
                       if device_type is None or d.type == device_type)


def resolve_device(device: Union[str, torch.device, Device, None] = "cuda"
                   ) -> torch.device:
    """``torch.device`` for ``device`` (``None`` means ``"cuda"``).
    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    available."""
    if isinstance(device, Device):
        device = "cpu" if device.is_cpu else f"cuda:{device.index}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (a kernel wrapper sizes
    its grid by it on every call, so the query is cached)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
