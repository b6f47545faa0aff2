"""AMP: the autocast context and dynamic loss scaling (counterpart of
``hetu_tpu.graph.amp``).

* :class:`autocast` is a graph-construction context: an op recorded
  inside it gets the cast folded into its impl (``wrap_impl``, called by
  ``ops.functional._op``), with the JAX package's op tables:
  matmul-class ops cast their floating inputs down to the autocast dtype
  (so fp32 models reach the bf16 flash route), numerically sensitive ops
  (losses, norms) cast up to fp32.  ``Graph.make_op`` infers shapes by
  running the wrapped impl on ``meta`` tensors, where the casts run too.
* :class:`GradScaler` is dynamic loss scaling: the step scales the loss,
  unscales the gradients, skips the update when any gradient is not
  finite and grows or backs off the scale.  Its state (``scale`` fp32,
  ``good_steps`` int32) lives in tensors on the graph's device that the
  step updates in place, so a captured step replays it: the skip is a
  device-side select (``Optimizer._commit``), with no host branch.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..core.dtype import torch_dtype

# Ops whose inputs are cast DOWN to the autocast dtype (tensor-core bound).
_LOW_PRECISION_OPS = frozenset({
    "matmul", "batch_matmul", "linear", "einsum", "conv2d",
    "fused_lm_cross_entropy",
    "attention", "parallel_attention", "flash_attention",
})
# Ops whose floating inputs are cast UP to fp32 (numerically sensitive).
_FULL_PRECISION_OPS = frozenset({
    "softmax_cross_entropy", "nll_loss", "mse_loss", "kl_div",
    "bce", "vocab_parallel_cross_entropy",
    "log_softmax", "layer_norm", "rms_norm", "batch_norm",
})

_autocast_stack: List[Any] = []


class autocast:
    """``with ht.autocast("bfloat16"):`` around the model's
    construction."""

    def __init__(self, dtype="bfloat16", enabled: bool = True):
        self.dtype = torch_dtype(dtype)
        self.enabled = enabled

    def __enter__(self):
        _autocast_stack.append(self if self.enabled else None)
        return self

    def __exit__(self, *exc):
        _autocast_stack.pop()


def current_autocast() -> Optional[autocast]:
    return _autocast_stack[-1] if _autocast_stack else None


def _cast_floats(args, dtype):
    return [a.to(dtype) if isinstance(a, torch.Tensor)
            and a.is_floating_point() and a.dtype != dtype else a
            for a in args]


def wrap_impl(op_type: str, impl):
    """``impl`` with the ambient autocast policy folded in (the op
    factory calls it when it records the op)."""
    ac = current_autocast()
    if ac is None:
        return impl
    if op_type in _LOW_PRECISION_OPS:
        lo = ac.dtype

        def low(*args, **kw):
            return impl(*_cast_floats(args, lo), **kw)
        return low
    if op_type in _FULL_PRECISION_OPS:
        def full(*args, **kw):
            return impl(*_cast_floats(args, torch.float32), **kw)
        return full
    return impl


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

def check_finite(grads) -> torch.Tensor:
    """A device bool: every floating tensor of ``grads`` is finite."""
    flags = [torch.isfinite(g).all() for g in grads
             if isinstance(g, torch.Tensor) and g.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


class GradScaler:
    """Dynamic loss scaling (reference ``hetu/graph/autocast/grad_scaler.*``):
    pass it to ``Optimizer.minimize(loss, grad_scaler=...)``."""

    def __init__(self, init_scale: float = 2.0 ** 16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, enabled: bool = True):
        self.init_scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.enabled = enabled
        self._state: Optional[Dict[str, torch.Tensor]] = None

    def init_state(self, device="cpu") -> Dict[str, torch.Tensor]:
        """The state tensors (made on ``device`` at the first call)."""
        if self._state is None:
            self._state = {
                "scale": torch.full((), self.init_scale, dtype=torch.float32,
                                    device=device),
                "good_steps": torch.zeros((), dtype=torch.int32,
                                          device=device)}
        return self._state

    def store_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Copies ``state`` into the state tensors, in place where they
        exist (a captured step keeps reading them)."""
        if self._state is None:
            self._state = {k: v.clone() for k, v in state.items()}
            return
        with torch.no_grad():
            for k, v in state.items():
                self._state[k].copy_(v)

    @property
    def scale(self) -> float:
        """The current scale (read from the device: a sync)."""
        if self._state is None:
            return self.init_scale
        return float(self._state["scale"])

    def scale_loss(self, loss, state):
        if not self.enabled:
            return loss
        # in fp32: the default scale 2**16 exceeds fp16's range
        return loss.float() * state["scale"]

    def unscale_loss(self, loss, state):
        if not self.enabled:
            return loss
        return loss.float() / state["scale"]

    def unscale_grads(self, grads, state):
        if not self.enabled:
            return grads
        inv = 1.0 / state["scale"]
        return [g * inv.to(g.dtype) if g.is_floating_point() else g
                for g in grads]

    @torch.no_grad()
    def update_state(self, state, finite) -> Dict[str, torch.Tensor]:
        """The ``update_scale`` op: grow after ``growth_interval``
        consecutive finite steps, back off at once on overflow.  Writes
        the new values into ``state``'s tensors and returns it."""
        if not self.enabled:
            return state
        good = torch.where(finite, state["good_steps"] + 1,
                           torch.zeros_like(state["good_steps"]))
        grow = good >= self.growth_interval
        scale = torch.where(
            finite,
            torch.where(grow, state["scale"] * self.growth_factor,
                        state["scale"]),
            state["scale"] * self.backoff_factor)
        state["scale"].copy_(scale)
        state["good_steps"].copy_(torch.where(grow, torch.zeros_like(good),
                                              good))
        return state
