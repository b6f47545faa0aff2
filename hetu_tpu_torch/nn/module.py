"""Modules over graph parameters (counterpart of ``hetu_tpu.nn.module``).

``Module`` is a ``torch.nn.Module`` whose parameters are graph
``Tensor``s (trainable variables of the active graph) instead of
``torch.nn.Parameter``s: assigning one to an attribute registers it, and
``forward`` records ops on the graph.  ``named_parameters`` walks the
attribute paths, so ``state_dict()`` keys are the JAX package's
(``transformer.h.0.attn.qkv.weight``); values are the graph's current
tensors, then the buffers.

The rest of the JAX Module surface comes from ``torch.nn.Module``:
``add_module``, ``named_modules``/``modules``, ``train``/``eval`` (the
``training`` flag that ``Dropout`` reads), ``apply`` and
``named_buffers``.  ``register_buffer`` also takes numpy arrays, which
become CPU tensors, as the JAX package's buffers are host arrays.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..graph.tensor import Tensor


class Module(torch.nn.Module):
    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_graph_params", OrderedDict())

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Tensor) and value.trainable:
            self._graph_params[name] = value
            object.__setattr__(self, name, value)
        else:
            super().__setattr__(name, value)

    def register_parameter(self, name: str,
                           param: Optional[Tensor]) -> None:
        self._graph_params[name] = param
        object.__setattr__(self, name, param)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True
                         ) -> Iterator[Tuple[str, Tensor]]:
        for name, p in self._graph_params.items():
            if p is not None:
                yield f"{prefix}{name}", p
        if recurse:
            for mname, m in self._modules.items():
                if isinstance(m, Module):
                    yield from m.named_parameters(f"{prefix}{mname}.", True)

    def parameters(self, recurse: bool = True) -> Iterator[Tensor]:
        for _, p in self.named_parameters(recurse=recurse):
            yield p

    def register_buffer(self, name: str, tensor, persistent: bool = True
                        ) -> None:
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor, persistent)

    def state_dict(self) -> "OrderedDict[str, torch.Tensor]":
        """Attribute-path name -> the parameter's current value, then the
        buffers.  On a mesh of several ranks the values are global
        (``Graph.global_value``: every rank calls it)."""
        def value(p):
            mesh = getattr(p.graph, "mesh", None)
            if mesh is not None and mesh.size > 1:
                return p.graph.global_value(p)
            return p.get_data().detach()
        out = OrderedDict((name, value(p))
                          for name, p in self.named_parameters())
        for name, b in self.named_buffers():
            out[name] = b
        return out

    def _set_buffer(self, path: str, value) -> None:
        mod_path, _, leaf = path.rpartition(".")
        mod = self.get_submodule(mod_path) if mod_path else self
        cur = mod._buffers[leaf]
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        mod._buffers[leaf] = value.to(device=cur.device, dtype=cur.dtype)

    def load_state_dict(self, state: Dict[str, Any], strict: bool = True):
        """Writes ``state`` (tensors or numpy arrays, under the names of
        ``state_dict``) into the graph's variables and the buffers; with
        ``strict`` a missing or unexpected name raises ``KeyError``."""
        missing, loaded = [], set()
        for name, p in self.named_parameters():
            if name in state:
                p.graph.reset_variable(p, state[name])
                loaded.add(name)
            elif strict:
                missing.append(name)
        for name, _ in self.named_buffers():
            if name in state:
                self._set_buffer(name, state[name])
                loaded.add(name)
            elif strict:
                missing.append(name)
        unexpected = [k for k in state if k not in loaded]
        if strict and (missing or unexpected):
            raise KeyError(f"missing={missing} unexpected={unexpected}")
        return missing, unexpected


class Sequential(Module):
    """Applies its modules in order; built from modules, or from one
    ``OrderedDict`` of named modules."""

    def __init__(self, *modules: Module):
        super().__init__()
        if len(modules) == 1 and isinstance(modules[0], OrderedDict):
            for name, m in modules[0].items():
                self.add_module(name, m)
        else:
            for i, m in enumerate(modules):
                self.add_module(str(i), m)

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx: int):
        return list(self._modules.values())[idx]


class ModuleList(Module):
    def __init__(self, modules=()):
        super().__init__()
        for i, m in enumerate(modules):
            self.add_module(str(i), m)

    def append(self, module: Module) -> "ModuleList":
        self.add_module(str(len(self._modules)), module)
        return self

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


class ModuleDict(Module):
    def __init__(self, modules: Optional[Dict[str, Module]] = None):
        super().__init__()
        for name, m in (modules or {}).items():
            self.add_module(name, m)

    def __getitem__(self, key: str) -> Module:
        return self._modules[key]

    def __setitem__(self, key: str, module: Module) -> None:
        self.add_module(key, module)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()
