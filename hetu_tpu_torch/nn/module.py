"""Modules over graph parameters (counterpart of ``hetu_tpu.nn.module``).

``Module`` is a ``torch.nn.Module`` whose parameters are graph
``Tensor``s (trainable variables of the active graph) instead of
``torch.nn.Parameter``s: assigning one to an attribute registers it, and
``forward`` records ops on the graph.  ``named_parameters`` walks the
attribute paths, so ``state_dict()`` keys are the JAX package's
(``transformer.h.0.attn.qkv.weight``); values are the graph's current
tensors.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Optional, Tuple

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

    def state_dict(self) -> "OrderedDict[str, torch.Tensor]":
        """Attribute-path name -> the parameter's current value."""
        return OrderedDict((name, p.get_data().detach())
                           for name, p in self.named_parameters())

    def load_state_dict(self, state: Dict[str, Any], strict: bool = True):
        """Writes ``state`` (tensors or numpy arrays, under the names of
        ``state_dict``) into the graph's variables; with ``strict`` a
        missing or unexpected name raises ``KeyError``."""
        missing, loaded = [], set()
        for name, p in self.named_parameters():
            if name in state:
                p.graph.reset_variable(p, state[name])
                loaded.add(name)
            elif strict:
                missing.append(name)
        unexpected = [k for k in state if k not in loaded]
        if strict and (missing or unexpected):
            raise KeyError(f"missing={missing} unexpected={unexpected}")
        return missing, unexpected


class ModuleList(Module):
    def __init__(self, modules=()):
        super().__init__()
        for i, m in enumerate(modules):
            self.add_module(str(i), m)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]
