"""On-device numeric sentry: silent-failure detection in the train step
(counterpart of ``hetu_tpu.resilience.sentry``).

The failures that corrupt long runs are silent: a NaN or Inf gradient
or a loss spike that poisons the optimizer's state and shows up
thousands of steps later.  The sentry checks every UPDATE step on the
device, from signals the step already makes:

* **verdict** -- a float32 vector of :data:`VERDICT_SLOTS` lanes (the
  ``V_*`` indices) from the fp32 global sum of squared gradients (the
  one the global-norm clip reads; NaN and Inf propagate through it, so
  its finiteness is the all-gradients finite check), the finiteness of
  the loss, a norm spike and a loss spike against an EMA of the clean
  steps' losses.
* **skip** -- the verdict's ``ok`` is ANDed into the optimizer's
  ``keep`` select (``Optimizer._commit``): a skipped step leaves the
  parameters, the moments, the flat buffers and the step counter
  bitwise as they were, with no host branch.  A loss scaler's own
  backoff still applies on a non-finite step, as in the JAX package.
* **one host read** -- the graph packs the loss and the verdict into
  one vector and copies it to the host once a step
  (``DefineAndRunGraph.run``); :meth:`NumericSentry.last_verdict` decodes
  that copy.  An injection is a value fed through the plan's static
  buffers: poisoned and clean steps replay one captured graph.

Everything here is torch ops on the step's device.  On a mesh the
verdict reads the dp-reduced loss and the globally reduced sum of
squares, so every rank takes the same verdict; the injection seam
poisons the rank's own loss and gradients before they are reduced,
where a real silent fault would surface.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: verdict vector layout (float32 lanes)
VERDICT_SLOTS = 7
(V_ANOMALY, V_LOSS_NONFINITE, V_GRAD_NONFINITE, V_GRAD_SPIKE,
 V_LOSS_SPIKE, V_CONSECUTIVE, V_GRAD_NORM) = range(VERDICT_SLOTS)

#: chaos injection codes (the int32 the graph feeds each step; 0 = clean),
#: keyed by the FaultPlan event kinds the trainer injects
INJECT_CODES: Dict[str, int] = {"grad_nan": 1, "grad_spike": 2,
                                "loss_spike": 3}


@dataclass(frozen=True)
class SentryConfig:
    """Thresholds of the numeric sentry (all checked on the device)."""
    #: global grad norm above this is a spike even when finite
    grad_norm_max: float = 1e4
    #: loss > factor * EMA(clean losses) is a spike (after warmup)
    loss_spike_factor: float = 8.0
    #: EMA decay of the clean-step loss
    loss_ema_decay: float = 0.9
    #: spike verdicts need this many clean steps of EMA history first
    warmup_steps: int = 2
    #: chaos seam: what grad_spike injection multiplies gradients by
    inject_grad_scale: float = 1e6
    #: chaos seam: what loss_spike injection multiplies the loss by
    inject_loss_scale: float = 64.0


class NumericSentry:
    """The sentry's device state (loss EMA, clean steps seen, consecutive
    anomalies, last verdict) and the functions the graph runs in the step.

    Lives on the optimizer (``Optimizer(sentry=...)``), as in the JAX
    package.  The state tensors are made on the step's device at the
    first step and updated in place, so a captured step keeps reading
    them; :meth:`reset` zeroes them in place."""

    def __init__(self, config: Optional[SentryConfig] = None):
        self.config = config or SentryConfig()
        self._state: Optional[Dict[str, torch.Tensor]] = None
        # the last step's loss and verdict, on the host
        self._host_packet: Optional[torch.Tensor] = None
        # verdict reads (one a step, from the step's one host copy)
        self.host_reads = 0

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        if self._state is None:
            self._state = {
                "ema": torch.zeros((), dtype=torch.float32, device=device),
                "seen": torch.zeros((), dtype=torch.int32, device=device),
                "consecutive": torch.zeros((), dtype=torch.int32,
                                           device=device),
                "verdict": torch.zeros((VERDICT_SLOTS,), dtype=torch.float32,
                                       device=device)}
        return self._state

    def reset(self) -> None:
        """Forget the EMA and the anomaly streak (after a rewind: the
        restored state predates them)."""
        if self._state is not None:
            with torch.no_grad():
                for v in self._state.values():
                    v.zero_()
        self._host_packet = None

    def last_verdict(self) -> Optional[Dict[str, Any]]:
        """The last UPDATE step's verdict, decoded from the host copy the
        step made beside its loss; ``None`` before the first step."""
        if self._host_packet is None:
            return None
        self.host_reads += 1
        return decode_verdict(self._host_packet[1:].numpy())

    # -- in the step: the injection seam ----------------------------------

    @staticmethod
    def _select(code: torch.Tensor, cases, default: float) -> torch.Tensor:
        one = torch.full((), default, dtype=torch.float32,
                         device=code.device)
        out = one
        for c, v in reversed(cases):
            out = torch.where(code == c, torch.full_like(one, v), out)
        return out

    def grad_factor(self, code: torch.Tensor) -> torch.Tensor:
        return self._select(code, [(INJECT_CODES["grad_nan"], float("nan")),
                                   (INJECT_CODES["grad_spike"],
                                    self.config.inject_grad_scale)], 1.0)

    def inject_grads(self, grads: List[torch.Tensor], code: torch.Tensor
                     ) -> List[torch.Tensor]:
        """Every gradient times the factor ``code`` selects (1.0 when
        clean: a bitwise identity)."""
        f = self.grad_factor(code)
        return [g * f.to(g.dtype) for g in grads]

    def inject_loss(self, loss: torch.Tensor, code: torch.Tensor
                    ) -> torch.Tensor:
        f = self._select(code, [(INJECT_CODES["loss_spike"],
                                 self.config.inject_loss_scale)], 1.0)
        return loss * f.to(loss.dtype)

    # -- in the step: the verdict --------------------------------------------

    def update(self, loss: torch.Tensor, grad_sq_norm: torch.Tensor
               ) -> torch.Tensor:
        """The step's verdict from the (reduced) loss and the fp32 global
        sum of squared gradients before the clip; updates the state in
        place and returns ``ok``, the device bool the optimizer ANDs into
        its ``keep``."""
        cfg = self.config
        st = self.init_state(loss.device)
        loss32 = loss.detach().float().reshape(())
        gnorm = torch.sqrt(grad_sq_norm.detach().float().reshape(()))
        loss_fin = torch.isfinite(loss32)
        grad_fin = torch.isfinite(gnorm)
        grad_spike = grad_fin & (gnorm > cfg.grad_norm_max)
        warm = st["seen"] >= cfg.warmup_steps
        loss_spike = loss_fin & warm & (
            loss32 > float(np.float32(cfg.loss_spike_factor)) * st["ema"])
        anomaly = ~loss_fin | ~grad_fin | grad_spike | loss_spike
        ok = ~anomaly
        # the decay and its complement in float32, as the JAX package has
        d = np.float32(cfg.loss_ema_decay)
        ema_next = torch.where(st["seen"] > 0,
                               float(d) * st["ema"] +
                               float(np.float32(1.0) - d) * loss32, loss32)
        consecutive = torch.where(ok, torch.zeros_like(st["consecutive"]),
                                  st["consecutive"] + 1)
        verdict = torch.stack([
            anomaly.float(), (~loss_fin).float(), (~grad_fin).float(),
            grad_spike.float(), loss_spike.float(), consecutive.float(),
            gnorm])
        with torch.no_grad():
            st["ema"].copy_(torch.where(ok, ema_next, st["ema"]))
            st["seen"].add_(ok.to(torch.int32))
            st["consecutive"].copy_(consecutive)
            st["verdict"].copy_(verdict)
        return ok

    def packet(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss and the verdict in one float32 vector: the step's one
        copy to the host."""
        return torch.cat([loss.detach().float().reshape(1),
                          self._state["verdict"]])

    def meta(self) -> Dict[str, Any]:
        """The thresholds the verdict enforces."""
        cfg = self.config
        return {"grad_norm_max": cfg.grad_norm_max,
                "loss_spike_factor": cfg.loss_spike_factor,
                "warmup_steps": cfg.warmup_steps,
                "slots": VERDICT_SLOTS}


def as_sentry(sentry) -> Optional[NumericSentry]:
    """``True``, a :class:`SentryConfig` or a :class:`NumericSentry` as a
    sentry; a false value as ``None``."""
    if not sentry:
        return None
    if sentry is True:
        return NumericSentry()
    if isinstance(sentry, SentryConfig):
        return NumericSentry(sentry)
    if isinstance(sentry, NumericSentry):
        return sentry
    raise ValueError(f"sentry must be True, a SentryConfig or a "
                     f"NumericSentry, got {sentry!r}")


def decode_verdict(arr) -> Dict[str, Any]:
    """Unpack a verdict vector into named fields."""
    a = np.asarray(arr, np.float32)
    return {
        "anomaly": bool(a[V_ANOMALY]),
        "loss_nonfinite": bool(a[V_LOSS_NONFINITE]),
        "grad_nonfinite": bool(a[V_GRAD_NONFINITE]),
        "grad_spike": bool(a[V_GRAD_SPIKE]),
        "loss_spike": bool(a[V_LOSS_SPIKE]),
        "consecutive": int(a[V_CONSECUTIVE]),
        "grad_norm": float(a[V_GRAD_NORM]),
    }
