"""Optimizers (counterpart of ``hetu_tpu.optim.optimizer``).

``minimize(loss)`` records an update node; ``DefineAndRunGraph.run``
executes it after the micro-batch loop with the 1/M-normalised
gradients, updating the parameters in place (the JAX package returns
new arrays; the update math is the same).  Adam keeps fp32 moments,
applies bias correction, computes the update in fp32 and casts it to the
parameter's dtype; ``AdamOptimizer`` adds an L2 weight decay to the
gradient, ``AdamWOptimizer`` a decoupled one.  ``max_grad_norm`` clips
by the global fp32 norm first.  The whole update runs on the device, the
step count included (an fp32 tensor, as the JAX optimizer keeps ``step``
in its state), so a captured training step replays it with the right
bias correction every time.  ZeRO, flat state, explicit gradient
communication, lr schedules and the numeric sentry come with later
slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..graph.graph import OpNode, get_default_graph
from ..graph.tensor import Tensor


class Optimizer:
    def __init__(self, params: Optional[Sequence[Tensor]] = None,
                 lr=0.01, zero: int = 0, dp_axis: str = "dp",
                 max_grad_norm: Optional[float] = None,
                 grad_comm: Optional[str] = None, bucket_mb: float = 4.0,
                 flat_state: bool = False, sentry=None):
        if callable(lr):
            raise NotImplementedError(
                "lr schedules are ported in a later slice; pass a float lr")
        self.lr = float(lr)
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
        """The update op for ``loss``: fetch it in ``run`` to train."""
        if grad_scaler is not None:
            raise NotImplementedError(
                "loss scaling (AMP / GradScaler) is ported in a later slice")
        g = loss.graph or get_default_graph()
        xs = list(var_list or self.params or g.trainable_variables)
        if not xs:
            raise ValueError("no trainable variables to optimize")
        grads = g.make_gradients(loss, xs)
        node = OpNode("update", None, grads,
                      {"optimizer": self, "grad_node": grads[0].producer,
                       "xs": xs}, f"update_{loss.name}")
        t = Tensor((), "float32", producer=node, name=node.name, graph=g)
        node.outputs = [t]
        g.ops.append(node)
        return t

    def _clip_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Global-norm clip across all parameter grads (fp32 norm)."""
        if self.max_grad_norm is None:
            return grads
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
        scale = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]

    def _apply_updates(self, graph, xs: Sequence[Tensor],
                       grads: List[torch.Tensor]) -> None:
        raise NotImplementedError

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


class AdamOptimizer(Optimizer):
    """Adam with fp32 moments (L2 weight decay on the gradient)."""

    decoupled_weight_decay = False     # True in AdamW

    def __init__(self, params=None, lr: float = 1e-3, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, **kw):
        super().__init__(params, lr, **kw)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.weight_decay = weight_decay

    @torch.no_grad()
    def _apply_updates(self, graph, xs, grads):
        grads = self._clip_grads(grads)
        st = self._state
        if not st:
            dev = graph.device
            st.update(step=torch.zeros((), dtype=torch.float32, device=dev),
                      betas=torch.tensor([self.beta1, self.beta2],
                                         dtype=torch.float32, device=dev),
                      m={}, v={})
        b1, b2, lr, wd = self.beta1, self.beta2, self.lr, self.weight_decay
        step = st["step"].add_(1.0)
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
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_((g * g) * (1 - b2))
            upd = (m / bc1).mul_(lr).div_((v / bc2).sqrt_().add_(self.eps))
            if wd and self.decoupled_weight_decay:
                upd.add_(p.float() * (lr * wd))
            p.copy_((p.float() - upd).to(p.dtype))


class AdamWOptimizer(AdamOptimizer):
    """AdamW: decoupled weight decay (torch.optim.AdamW semantics)."""
    decoupled_weight_decay = True
