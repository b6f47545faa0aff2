"""Optimizers (counterpart of ``hetu_tpu.optim.optimizer``).

``minimize(loss)`` records an update node; ``DefineAndRunGraph.run``
executes it after the micro-batch loop with the 1/M-normalised
gradients, updating the parameters in place (the JAX package returns
new arrays; the update math is the same).  ``max_grad_norm`` clips by the
global fp32 norm first.

- ``SGDOptimizer``: plain, momentum or Nesterov; the velocity keeps the
  parameter's dtype and the update is taken in fp32 and cast back.
- ``AdamOptimizer`` / ``AdamWOptimizer``: fp32 moments, bias correction,
  the update in fp32 cast to the parameter's dtype; Adam adds an L2
  weight decay to the gradient, AdamW a decoupled one.
- ``AdafactorOptimizer``: optax's ``adafactor`` chain, which the JAX
  package delegates to, re-implemented in torch on the per-parameter
  path: factored second moments (row/col EMAs of the squared gradient for
  parameters with two dims of at least ``min_dim_size_to_factor``), the
  block-RMS clip, the lr, the parameter-scale factor, momentum, weight
  decay and the sign.

The whole update runs on the device, the step counts included (tensors
that the update increments in place), so a captured training step
replays it right every time: a scheduled ``lr`` (``optim.schedules``) is
computed from the step tensor on the device, 1-based as in the JAX
package.  A ``GradScaler`` passes ``keep``, a device bool: the update is
computed and then selected against the old values (``torch.where``), so a
step with a non-finite gradient leaves parameters, moments and step
counts bitwise unchanged without a host branch.

Checkpoints carry the JAX package's state keys: ``checkpoint_state`` and
``load_checkpoint_state`` map between them and this optimizer's tensors
(``opt.step`` int32 for Adam's fp32 step count, no ``opt.betas``;
Adafactor's optax leaves by index, ``opt.optax@@leafNNNN``, in the order
of optax's state tree).  ZeRO, flat state, explicit gradient
communication and the numeric sentry come with later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph.graph import OpNode, get_default_graph
from ..graph.tensor import Tensor


class Optimizer:
    def __init__(self, params: Optional[Sequence[Tensor]] = None,
                 lr=0.01, zero: int = 0, dp_axis: str = "dp",
                 max_grad_norm: Optional[float] = None,
                 grad_comm: Optional[str] = None, bucket_mb: float = 4.0,
                 flat_state: bool = False, sentry=None):
        # a float, or a schedule step -> lr (optim.schedules)
        self.lr = lr if callable(lr) or lr is None else float(lr)
        self.params = list(params) if params is not None else None
        self.zero = int(zero)
        if not 0 <= self.zero <= 3:
            raise ValueError(f"zero level must be 0..3, got {zero}")
        if self.zero or grad_comm is not None or flat_state:
            raise NotImplementedError(
                "ZeRO (zero > 0), flat_state and grad_comm are ported with "
                "the multi-GPU mesh (ROADMAP queue 1, items 10-14)")
        if sentry:
            raise NotImplementedError(
                "the numeric sentry is ported in a later slice (resilience)")
        self.dp_axis = dp_axis
        self.max_grad_norm = max_grad_norm
        self._state: Dict[str, Any] = {}

    def minimize(self, loss: Tensor,
                 var_list: Optional[Sequence[Tensor]] = None,
                 grad_scaler=None) -> Tensor:
        """The update op for ``loss``: fetch it in ``run`` to train.  With
        ``grad_scaler`` (``graph.amp.GradScaler``) the loss is scaled, the
        gradients unscaled, and a step whose gradients are not finite
        is skipped on the device."""
        g = loss.graph or get_default_graph()
        xs = list(var_list or self.params or g.trainable_variables)
        if not xs:
            raise ValueError("no trainable variables to optimize")
        grads = g.make_gradients(loss, xs)
        node = OpNode("update", None, grads,
                      {"optimizer": self, "grad_node": grads[0].producer,
                       "xs": xs, "grad_scaler": grad_scaler},
                      f"update_{loss.name}")
        t = Tensor((), "float32", producer=node, name=node.name, graph=g)
        node.outputs = [t]
        g.ops.append(node)
        return t

    def _lr_at(self, step: torch.Tensor):
        """The lr of the step being applied: the float, or the schedule
        at ``step`` (1-based, a device tensor)."""
        return self.lr(step) if callable(self.lr) else self.lr

    @staticmethod
    def _commit(dst: torch.Tensor, new: torch.Tensor,
                keep: Optional[torch.Tensor]) -> None:
        """``dst = new``, or with ``keep`` (a device bool) ``dst = keep ?
        new : dst``: a skipped step leaves ``dst`` bitwise unchanged.
        ``new`` may be ``dst`` itself, updated in place (no ``keep``)."""
        if new is dst:
            return
        new = new.to(dst.dtype)
        dst.copy_(new if keep is None else torch.where(keep, new, dst))

    def _clip_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Global-norm clip across all parameter grads (fp32 norm)."""
        if self.max_grad_norm is None:
            return grads
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
        scale = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    def _apply_updates(self, graph, xs: Sequence[Tensor],
                       grads: List[torch.Tensor],
                       keep: Optional[torch.Tensor] = None) -> None:
        raise NotImplementedError

    def _zeros_step(self, device) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=device)

    def state_dict(self) -> Dict[str, Any]:
        """A copy of the optimizer's state: its tensors (the step count,
        per-variable moments keyed by variable id) cloned."""
        def copy(v):
            if isinstance(v, dict):
                return {k: copy(x) for k, x in v.items()}
            return v.clone() if isinstance(v, torch.Tensor) else v
        return copy(self._state)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Resume from :meth:`state_dict`.  Values are copied into the
        tensors this optimizer already holds, so a captured step keeps
        reading them; new entries are taken as clones."""
        def load(dst, src):
            for k, v in src.items():
                cur = dst.get(k)
                if isinstance(v, dict):
                    load(dst.setdefault(k, {}), v)
                elif isinstance(cur, torch.Tensor) and \
                        cur.shape == v.shape and cur.dtype == v.dtype:
                    cur.copy_(v)
                else:
                    dst[k] = v.clone() if isinstance(v, torch.Tensor) else v
        with torch.no_grad():
            load(self._state, state)

    # -- checkpoints (the JAX package's keys) -------------------------------

    # per-parameter state slots and their dtype (None: the parameter's)
    _SLOTS: Dict[str, Optional[torch.dtype]] = {}

    def checkpoint_state(self, tid_to_name: Dict[int, str]
                         ) -> Dict[str, torch.Tensor]:
        """The state under the JAX package's checkpoint keys (without the
        ``opt.`` prefix): ``step`` as int32, ``<slot>.<param name>``."""
        st = self._state
        if not st:
            return {}
        out = {"step": st["step"].to(torch.int32)}
        for slot in self._SLOTS:
            for tid, val in st.get(slot, {}).items():
                out[f"{slot}.{tid_to_name.get(tid, str(tid))}"] = val
        return out

    def load_checkpoint_state(self, entries: Dict[str, torch.Tensor],
                              name_to_param: Dict[str, Tensor],
                              device) -> None:
        """Loads ``entries`` (keys as :meth:`checkpoint_state` writes them)
        into this optimizer's tensors, in place where they exist."""
        state: Dict[str, Any] = {}
        for key, val in entries.items():
            slot, _, pname = key.partition(".")
            if key == "step":
                state["step"] = val.to(device=device, dtype=torch.float32)
            elif slot in self._SLOTS and pname in name_to_param:
                p = name_to_param[pname]
                dt = self._SLOTS[slot] or p.dtype
                state.setdefault(slot, {})[p.id] = val.to(device=device,
                                                          dtype=dt)
        state.update(self._fixed_state(device))
        self.load_state_dict(state)

    def _fixed_state(self, device) -> Dict[str, torch.Tensor]:
        """State tensors that hold hyper-parameters, not training
        progress (checkpoints leave them out)."""
        return {}


class SGDOptimizer(Optimizer):
    """SGD, with momentum and Nesterov (``torch.optim.SGD`` semantics)."""

    def __init__(self, params=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, **kw):
        super().__init__(params, lr, **kw)
        self.momentum = momentum
        self.nesterov = nesterov
        self._SLOTS = {"velocity": None} if momentum != 0.0 else {}

    @torch.no_grad()
    def _apply_updates(self, graph, xs, grads, keep=None):
        grads = self._clip_grads(grads)
        st = self._state
        if "step" not in st:
            st["step"] = self._zeros_step(graph.device)
        step = st["step"] + 1.0
        lr = self._lr_at(step)
        for t, grad in zip(xs, grads):
            p = graph._var_data[t.id]
            g = grad.to(p.dtype)
            if self.momentum == 0.0:
                upd = g
            else:
                vel = st.setdefault("velocity", {})
                v = vel.get(t.id)
                if v is None:
                    v = vel[t.id] = torch.zeros_like(p)
                v_new = self.momentum * v + g
                upd = g + self.momentum * v_new if self.nesterov else v_new
                self._commit(v, v_new, keep)
            self._commit(p, p.float() - lr * upd.float(), keep)
        self._commit(st["step"], step, keep)


class AdamOptimizer(Optimizer):
    """Adam with fp32 moments (L2 weight decay on the gradient)."""

    decoupled_weight_decay = False     # True in AdamW
    _SLOTS = {"m": torch.float32, "v": torch.float32}

    def __init__(self, params=None, lr: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, **kw):
        super().__init__(params, lr, **kw)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay

    def _fixed_state(self, device):
        return {"betas": torch.tensor([self.beta1, self.beta2],
                                      dtype=torch.float32, device=device)}

    @torch.no_grad()
    def _apply_updates(self, graph, xs, grads, keep=None):
        grads = self._clip_grads(grads)
        st = self._state
        if "step" not in st:
            dev = graph.device
            st.update(step=self._zeros_step(dev), **self._fixed_state(dev))
        st.setdefault("m", {})
        st.setdefault("v", {})
        b1, b2, wd = self.beta1, self.beta2, self.weight_decay
        step = st["step"] + 1.0
        lr = self._lr_at(step)
        # bias corrections in fp32 on the device, from the step tensor
        bc1, bc2 = 1.0 - st["betas"] ** step
        for t, grad in zip(xs, grads):
            p = graph._var_data[t.id]
            m = st["m"].get(t.id)
            if m is None:
                m = st["m"][t.id] = torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device)
                st["v"][t.id] = torch.zeros_like(m)
            v = st["v"][t.id]
            g = grad.float()
            if wd and not self.decoupled_weight_decay:
                g = g + wd * p.float()
            # in place unless a skip may have to keep the old moments
            if keep is None:
                m_new = m.mul_(b1).add_(g * (1 - b1))
                v_new = v.mul_(b2).add_((g * g) * (1 - b2))
            else:
                m_new = m * b1 + g * (1 - b1)
                v_new = v * b2 + (g * g) * (1 - b2)
            upd = (m_new / bc1).mul_(lr).div_(
                (v_new / bc2).sqrt_().add_(self.eps))
            if wd and self.decoupled_weight_decay:
                upd.add_(p.float() * (lr * wd))
            self._commit(m, m_new, keep)
            self._commit(v, v_new, keep)
            self._commit(p, p.float() - upd, keep)
        self._commit(st["step"], step, keep)


class AdamWOptimizer(AdamOptimizer):
    """AdamW: decoupled weight decay (torch.optim.AdamW semantics)."""
    decoupled_weight_decay = True


class AdafactorOptimizer(Optimizer):
    """Adafactor (Shazeer & Stern 2018) with optax's defaults and
    semantics, on the per-parameter path (``flat_state`` is refused with
    the other multi-GPU options).  ``lr=None`` (the default) leaves the
    lr out of the chain, as optax does; a schedule sees the 1-based
    step."""

    def __init__(self, params=None, lr=None, min_dim_size_to_factor=128,
                 decay_rate: float = 0.8, clipping_threshold: float = 1.0,
                 momentum: Optional[float] = None,
                 weight_decay_rate: Optional[float] = None,
                 multiply_by_parameter_scale: bool = True,
                 max_grad_norm: Optional[float] = None, **kw):
        super().__init__(params, lr, max_grad_norm=max_grad_norm, **kw)
        self.min_dim_size_to_factor = int(min_dim_size_to_factor)
        self.decay_rate = float(decay_rate)
        self.clipping_threshold = clipping_threshold
        self.momentum = momentum
        self.weight_decay_rate = weight_decay_rate
        self.multiply_by_parameter_scale = multiply_by_parameter_scale
        self.eps = 1e-30            # optax factorized epsilon

    def _factored_dims(self, shape):
        """optax's rule: the two largest dims, when the smaller of them
        has at least ``min_dim_size_to_factor`` entries."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def _init_param_state(self, p: torch.Tensor):
        """(v_row, v_col, v) of one parameter, fp32, as optax's init."""
        z1 = torch.zeros((1,), dtype=torch.float32, device=p.device)
        dims = self._factored_dims(tuple(p.shape))
        if dims is None:
            return z1, z1.clone(), torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
        d1, d0 = dims
        return (torch.zeros(np.delete(p.shape, d0).tolist(),
                            dtype=torch.float32, device=p.device),
                torch.zeros(np.delete(p.shape, d1).tolist(),
                            dtype=torch.float32, device=p.device),
                z1)

    def _ensure(self, graph, xs):
        st = self._state
        if "count" in st:
            return st
        dev = graph.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        st.update(count=zero.clone(), v_row={}, v_col={}, v={})
        if callable(self.lr):
            st["sched_count"] = zero.clone()
        if self.momentum is not None:
            st.update(ema_count=zero.clone(), ema={})
        for t in xs:
            p = graph._var_data[t.id]
            st["v_row"][t.id], st["v_col"][t.id], st["v"][t.id] = \
                self._init_param_state(p)
            if self.momentum is not None:
                st["ema"][t.id] = torch.zeros(p.shape, dtype=torch.float32,
                                              device=dev)
        return st

    @torch.no_grad()
    def _apply_updates(self, graph, xs, grads, keep=None):
        grads = self._clip_grads(grads)
        st = self._ensure(graph, xs)
        t_ = (st["count"] + 1).float()
        decay_t = 1.0 - t_ ** (-self.decay_rate)
        lr = None
        if callable(self.lr):
            # optax counts from 0; the JAX package's schedule sees count+1
            lr = self.lr(st["sched_count"] + 1)
        elif self.lr is not None:
            lr = self.lr
        for t, grad in zip(xs, grads):
            p_store = graph._var_data[t.id]
            p = p_store.float()
            g = grad.float()
            v_row, v_col, v = (st["v_row"][t.id], st["v_col"][t.id],
                               st["v"][t.id])
            grad_sqr = g * g + self.eps
            dims = self._factored_dims(tuple(p.shape))
            if dims is not None:
                d1, d0 = dims
                new_row = decay_t * v_row + (1.0 - decay_t) * \
                    grad_sqr.mean(dim=d0)
                new_col = decay_t * v_col + (1.0 - decay_t) * \
                    grad_sqr.mean(dim=d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = new_row.mean(dim=reduced_d1, keepdim=True)
                row_factor = (new_row / row_col_mean) ** -0.5
                col_factor = new_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
                self._commit(v_row, new_row, keep)
                self._commit(v_col, new_col, keep)
            else:
                new_v = decay_t * v + (1.0 - decay_t) * grad_sqr
                u = g * new_v ** -0.5
                self._commit(v, new_v, keep)
            if self.clipping_threshold is not None:
                rms = torch.sqrt(torch.mean(u * u))
                u = u / torch.clamp(rms / self.clipping_threshold, min=1.0)
            if lr is not None:
                u = u * lr
            if self.multiply_by_parameter_scale:
                rms = torch.sqrt(torch.mean(p * p))
                u = u * torch.clamp(rms, min=1e-3)
            if self.momentum is not None:
                ema = st["ema"][t.id]
                u = (1.0 - self.momentum) * u + self.momentum * ema
                self._commit(ema, u, keep)
            if self.weight_decay_rate is not None:
                u = u + self.weight_decay_rate * p
            self._commit(p_store, p - u, keep)
        for key in ("count", "sched_count", "ema_count"):
            if key in st:
                self._commit(st[key], st[key] + 1, keep)

    # optax's state tree, flattened: the chain's states in order, each
    # NamedTuple's fields in order, a dict of parameters by variable id
    def _leaves(self) -> List[torch.Tensor]:
        st = self._state
        tids = sorted(st["v"])
        leaves = [st["count"]]
        for slot in ("v_row", "v_col", "v"):
            leaves += [st[slot][tid] for tid in tids]
        if "sched_count" in st:
            leaves.append(st["sched_count"])
        if "ema_count" in st:
            leaves.append(st["ema_count"])
            leaves += [st["ema"][tid] for tid in tids]
        return leaves

    def checkpoint_state(self, tid_to_name):
        if "count" not in self._state:
            return {}
        return {f"optax@@leaf{i:04d}": leaf
                for i, leaf in enumerate(self._leaves())}

    def load_checkpoint_state(self, entries, name_to_param, device):
        leaves = [entries[k] for k in sorted(entries)
                  if k.startswith("optax@@leaf")]
        if not leaves:
            return
        graph = next(iter(name_to_param.values())).graph
        xs = sorted(name_to_param.values(), key=lambda t: t.id)
        for t in xs:
            graph._materialize_var(t)
        self._ensure(graph, xs)
        ref = self._leaves()
        if len(ref) != len(leaves) or any(
                tuple(a.shape) != tuple(b.shape)
                for a, b in zip(ref, leaves)):
            raise ValueError("checkpointed optimizer state 'optax' does not "
                             "match this optimizer/model (leaf count/shapes)")
        with torch.no_grad():
            for dst, src in zip(ref, leaves):
                dst.copy_(src.to(device=dst.device, dtype=dst.dtype))


# torch-style aliases
SGD = SGDOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
