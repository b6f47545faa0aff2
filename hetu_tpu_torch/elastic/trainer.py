"""Elastic Trainer: profile -> re-solve -> hot-switch loop (Malleus;
counterpart of ``hetu_tpu.elastic.trainer``).

The reference's ``Trainer``
(``python/elastic/engine/trainer.py:30``) and the retune call stack
(SURVEY.md §3.5): train under the current strategy, profile stragglers,
solve a new hetero layout with :class:`~hetu_tpu.elastic.StrategyModel`,
and when the plan changes migrate params/optimizer states live via
``DefineAndRunGraph.switch_strategy`` (``parallel.switch``).

SPMD is by process in the port: every rank runs the same Trainer loop,
the solver is deterministic and the straggler ratios are merged over the
ranks, so every rank takes the same decisions; a device of the solver is
a rank, and a plan's ``device_order`` lays the new mesh over the ranks
(``create_mesh(strategy.mesh_shape, ranks=order)``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..parallel.mesh import create_mesh
from .straggler import Straggler
from .strategy import Strategy, StrategyModel


class Trainer:
    """Drive elastic training over a DefineAndRunGraph.

    Parameters
    ----------
    graph : DefineAndRunGraph with a built model + ``train_op``
    loss, train_op : tensors from the user's model/optimizer build
    optimizer : the optimizer whose states must migrate on switch
    data_provider : callable(step) -> feed_dict
    solver : StrategyModel over the graph's devices
    num_micro_batches : global micro-batch count per step
    """

    def __init__(self, graph, loss, train_op, optimizer,
                 data_provider: Callable[[int], Dict[Any, Any]],
                 solver: StrategyModel,
                 num_micro_batches: int = 1,
                 straggler: Optional[Straggler] = None,
                 switch_threshold: float = 0.05,
                 hetero: str = "project"):
        if hetero not in ("project", "error"):
            raise ValueError(f"hetero must be 'project' or 'error', "
                             f"got {hetero!r}")
        self.graph = graph
        self.loss = loss
        self.train_op = train_op
        self.optimizer = optimizer
        self.data_provider = data_provider
        self.solver = solver
        self.num_micro_batches = num_micro_batches
        # the solver's devices: the ranks, in the built mesh's order
        self.devices = list(graph.mesh.ranks) if graph.mesh is not None \
            else [0]
        self.straggler = straggler or Straggler(len(self.devices))
        self.switch_threshold = switch_threshold
        # SPMD meshes are rectangular: a hetero plan (unequal per-pipeline
        # micro-batches / layer splits) is executed here as its homogeneous
        # projection ("project"); pass hetero="error" to fail instead and
        # route to ElasticMPMDTrainer (ROADMAP queue 1 item 11b), which
        # executes hetero plans exactly.
        self.hetero = hetero
        self.current_strategy: Optional[Strategy] = None
        self.history: List[Dict[str, Any]] = []
        self.step_idx = 0

    # -- training ------------------------------------------------------------

    def train_steps(self, steps: int) -> List[float]:
        losses = []
        for _ in range(steps):
            feeds = self.data_provider(self.step_idx)
            out = self.graph.run(self.loss, [self.loss, self.train_op],
                                 feeds,
                                 num_micro_batches=self.num_micro_batches)
            losses.append(float(out[0]))
            self.step_idx += 1
        return losses

    # -- profile + retune (reference Trainer.run inner loop) -----------------

    def profile(self, steps: int = 2) -> List[float]:
        self.straggler.begin_profile()
        self.train_steps(steps)
        self.straggler.end_profile(steps=steps)
        return self.straggler.read_profile()

    def retune(self, ratios: Optional[Sequence[float]] = None) -> bool:
        """Re-solve for ``ratios`` and hot-switch if the new plan is
        sufficiently better.  Returns True when a switch happened."""
        if ratios is None:
            ratios = self.straggler.read_profile()
        plans = self.solver.make_plans(ratios, top_k=1)
        if not plans:
            return False
        best = plans[0]
        if self.current_strategy is not None:
            # keep the CURRENT layout (fixed device order / layer split /
            # micro-batch counts) unless the re-solved plan beats it
            cur = self.solver.estimate(self.current_strategy, ratios)
            if best.est_step_time >= cur * (1 - self.switch_threshold):
                return False
        self._apply_strategy(best)
        return True

    def _apply_strategy(self, strat: Strategy) -> None:
        if strat.is_hetero and self.hetero == "error":
            raise RuntimeError(
                f"solved plan is heterogeneous ({strat.describe()}); the "
                "SPMD Trainer would only execute its homogeneous "
                "projection — ElasticMPMDTrainer executes hetero plans "
                "exactly (ROADMAP queue 1 item 11b: rank processes for a "
                "MPMD stage), or hetero='project' accepts the projection")
        ranks = [self.devices[i] for i in strat.device_order]
        cur = self.graph.mesh
        if cur is not None \
                and tuple(cur.axis_names) == tuple(strat.mesh_shape) \
                and dict(cur.shape) == dict(strat.mesh_shape) \
                and list(cur.ranks) == ranks:
            # identity layout (e.g. first retune confirms the built mesh):
            # adopt the plan without paying a param/optimizer migration
            self.current_strategy = strat
            return
        t0 = time.perf_counter()
        prof = None
        if cur is not None:
            new_mesh = create_mesh(strat.mesh_shape, device=self.graph.device,
                                   ranks=ranks)
            prof = self.graph.switch_strategy(new_mesh,
                                              optimizer=self.optimizer)
        self.history.append({
            "step": self.step_idx,
            "strategy": strat.describe(),
            "hetero_projected": strat.is_hetero,
            "switch_seconds": time.perf_counter() - t0,
            "switch_profile": prof.as_dict() if prof is not None else None,
        })
        self.current_strategy = strat

    def run(self, total_steps: int, profile_interval: int = 0,
            profile_steps: int = 2) -> List[float]:
        """Train ``total_steps``; when ``profile_interval`` > 0, profile and
        retune every that many steps (the reference's elastic loop)."""
        losses: List[float] = []
        while len(losses) < total_steps:
            if profile_interval:
                chunk = min(profile_interval, total_steps - len(losses))
                if chunk >= profile_steps:
                    self.straggler.begin_profile()
                    losses += self.train_steps(chunk)
                    self.straggler.end_profile(steps=chunk)
                    self.retune()
                else:
                    losses += self.train_steps(chunk)
            else:
                losses += self.train_steps(total_steps - len(losses))
        return losses
