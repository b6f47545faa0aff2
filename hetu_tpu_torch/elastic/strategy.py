"""Heterogeneity-aware parallel-strategy solver (Malleus; counterpart of
``hetu_tpu.elastic.strategy``, a copy of its numpy code).

The reference's ``StrategyModel``
(``python/elastic/engine/strategy.py:98``): given per-device straggler
ratios, solve a hetero TP/PP/DP placement — TP groups that quarantine slow
devices together (``solve_tp_arrangments_new``, ``strategy.py:281``),
pipeline patterns (``enumerate_pp_pattern``, ``:562``), per-stage layer
ranges and per-pipeline micro-batch counts (``solve_pp_arrangement``,
``:868``) — minimizing estimated step time.

The output :class:`Strategy` carries a *device permutation* for the new
mesh (slow devices grouped so they gate as few peers as possible; in the
port a device is a rank, and ``parallel.create_mesh(strategy.mesh_shape,
ranks=...)`` lays the mesh over them) plus the hetero layer/micro-batch
splits.  A rectangular SPMD
mesh executes the homogeneous projection; the hetero fields drive
per-pipeline layer ranges and micro-batch apportionment when stages are
laid out explicitly (gpt_pipeline) and are preserved for parity with the
reference's hetero execution.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Strategy:
    """One solved parallel layout."""
    tp: int
    pp: int
    dp: int
    device_order: List[int]              # permutation of device indices
    stage_layers: List[List[int]]        # per pipeline: layers per stage
    micro_batches: List[int]             # per pipeline (sums to global M)
    est_step_time: float
    tp_group_times: List[float] = field(default_factory=list)

    @property
    def is_hetero(self) -> bool:
        """True when the plan needs MPMD execution: unequal micro-batch
        apportionment or per-pipeline layer splits that differ — work a
        single rectangular SPMD program cannot make unequal (masking
        would burn the same wall clock on every device; reference
        ``DeducePipeline``, ``define_and_run_graph.cc:139``)."""
        return (len(set(self.micro_batches)) > 1
                or len({tuple(s) for s in self.stage_layers}) > 1)

    @property
    def mesh_shape(self) -> Dict[str, int]:
        # always emit all three axes (size-1 axes are legal meshes): dropping
        # e.g. 'tp' would strip it from param PartitionSpecs on a hot switch
        # and a later switch back to tp>1 would leave weights replicated
        return {"pp": self.pp, "dp": self.dp, "tp": self.tp}

    def describe(self) -> str:
        return (f"tp={self.tp} pp={self.pp} dp={self.dp} "
                f"stages={self.stage_layers} mb={self.micro_batches} "
                f"t~{self.est_step_time:.3f}")


def _partition_layers(num_layers: int, stage_times: Sequence[float]
                      ) -> Tuple[List[int], float]:
    """Split ``num_layers`` over stages with per-layer cost ``stage_times[s]``
    minimizing the max per-stage time (reference solve_pp_arrangement's
    layer-range solve).  Exact DP over (layer, stage) — L and S are small."""
    S = len(stage_times)
    if S == 1:
        return [num_layers], num_layers * stage_times[0]
    # dp[s][l] = min over first s stages handling l layers of max stage time
    INF = float("inf")
    dp = [[INF] * (num_layers + 1) for _ in range(S + 1)]
    choice = [[0] * (num_layers + 1) for _ in range(S + 1)]
    dp[0][0] = 0.0
    for s in range(1, S + 1):
        for l in range(num_layers + 1):
            # stage s takes k layers, the s-1 earlier stages take l-k
            # (each >=1 layer) -> 1 <= k <= l-(s-1)
            for k in range(1, l - (s - 1) + 1) if l else []:
                prev = dp[s - 1][l - k]
                if prev == INF:
                    continue
                t = max(prev, k * stage_times[s - 1])
                if t < dp[s][l]:
                    dp[s][l] = t
                    choice[s][l] = k
    out = []
    l = num_layers
    for s in range(S, 0, -1):
        k = choice[s][l]
        out.append(k)
        l -= k
    out.reverse()
    return out, dp[S][num_layers]


def _apportion(total: int, weights: Sequence[float]) -> List[int]:
    """Integer apportionment of ``total`` by ``weights`` (largest remainder);
    every entry gets at least 1 when total >= len(weights)."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    raw = w * total
    base = np.floor(raw).astype(int)
    if total >= len(w):
        base = np.maximum(base, 1)
    while base.sum() > total:
        base[int(np.argmax(base))] -= 1
    rem = raw - base
    while base.sum() < total:
        i = int(np.argmax(rem))
        base[i] += 1
        rem[i] = -1
    return base.tolist()


class StrategyModel:
    """Solve hetero TP/PP/DP layouts given straggler ratios.

    ``layer_comm_cost`` models per-layer TP-collective overhead relative to
    per-layer compute at tp=1 (the all-reduce's cost grows with tp);
    ``pipeline_p2p_cost`` models a stage-boundary transfer in layer units.
    """

    def __init__(self, num_devices: int, num_layers: int,
                 num_micro_batches: int = 1,
                 max_tp: Optional[int] = None,
                 tp_candidates: Optional[Sequence[int]] = None,
                 pp_candidates: Optional[Sequence[int]] = None,
                 layer_comm_cost: float = 0.1,
                 pipeline_p2p_cost: float = 0.05):
        self.n = num_devices
        self.num_layers = num_layers
        self.M = num_micro_batches
        self.max_tp = max_tp or num_devices
        self.tp_candidates = list(tp_candidates) if tp_candidates else None
        self.pp_candidates = list(pp_candidates) if pp_candidates else None
        self.layer_comm_cost = layer_comm_cost
        self.pipeline_p2p_cost = pipeline_p2p_cost
        # per-(stage times) layer-partition memo; reset per _solve_one
        self._pipe_cache: Dict[Tuple, Tuple] = {}

    @classmethod
    def from_calibration(cls, calibration, num_devices: int,
                         num_layers: int, batch: int, seq: int,
                         hidden: int, ffn: int, **kw) -> "StrategyModel":
        """Build with MEASURED comm/compute ratios instead of the default
        constants (planner.profile_hardware.Calibration; reference
        profile_hardware.py feeding the Galvatron cost model)."""
        consts = calibration.elastic_constants(batch, seq, hidden, ffn)
        kw.setdefault("layer_comm_cost", consts["layer_comm_cost"])
        kw.setdefault("pipeline_p2p_cost", consts["pipeline_p2p_cost"])
        return cls(num_devices, num_layers, **kw)

    # -- TP grouping (reference solve_tp_arrangments_new) --------------------

    def solve_tp_arrangements(self, ratios: Sequence[float], tp: int
                              ) -> Tuple[List[List[int]], List[float]]:
        """Group devices into TP groups of size ``tp``.  A TP group runs in
        lockstep, so its time is its *slowest* member: sorting by speed and
        chunking quarantines stragglers together (provably optimal for
        minimizing the sum — and the sorted prefix structure Malleus
        exploits)."""
        assert self.n % tp == 0
        order = sorted(range(self.n), key=lambda i: ratios[i])
        groups = [order[i * tp:(i + 1) * tp] for i in range(self.n // tp)]
        times = [max(ratios[i] for i in g) for g in groups]
        return groups, times

    # -- full plan solve -----------------------------------------------------

    def make_plans(self, ratios: Sequence[float],
                   top_k: int = 1) -> List[Strategy]:
        """Enumerate (tp, pp, dp) layouts, solve the hetero layer and
        micro-batch splits for each, rank by estimated step time."""
        assert len(ratios) == self.n
        plans: List[Strategy] = []
        tps = self.tp_candidates or \
            [t for t in (1, 2, 4, 8, 16) if t <= self.max_tp]
        for tp in tps:
            if self.n % tp:
                continue
            n_groups = self.n // tp
            groups, gtimes = self.solve_tp_arrangements(ratios, tp)
            pps = self.pp_candidates or \
                [p for p in (1, 2, 4, 8) if p <= n_groups]
            for pp in pps:
                if n_groups % pp:
                    continue
                dp = n_groups // pp
                plan = self._solve_one(tp, pp, dp, groups, gtimes)
                if plan is not None:
                    plans.append(plan)
        plans.sort(key=lambda p: p.est_step_time)
        return plans[:top_k] if top_k else plans

    def _step_time(self, mb: Sequence[int], pipe_tmax: Sequence[float],
                   pp: int, total_mb: int) -> float:
        return max((m + pp - 1) * t for m, t in zip(mb, pipe_tmax)) \
            / total_mb + (pp - 1) * self.pipeline_p2p_cost

    def _per_layer_cost(self, tp: int) -> float:
        return 1.0 / tp + self.layer_comm_cost * np.log2(max(tp, 1)) / 8

    def estimate(self, strat: Strategy, ratios: Sequence[float]) -> float:
        """Step time of an EXISTING layout (fixed device permutation, layer
        split and micro-batch counts) under new straggler ratios — what the
        current plan would actually cost if kept (reference Trainer compares
        this against the re-solved plan before hot-switching)."""
        tp, pp, dp = strat.tp, strat.pp, strat.dp
        per_layer = self._per_layer_cost(tp)
        pipe_tmax = []
        for p in range(dp):
            tmax = 0.0
            for s in range(pp):
                devs = strat.device_order[(s * dp + p) * tp:
                                          (s * dp + p + 1) * tp]
                gtime = max(ratios[d] for d in devs)
                tmax = max(tmax, strat.stage_layers[p][s] * per_layer * gtime)
            pipe_tmax.append(tmax)
        return self._step_time(strat.micro_batches, pipe_tmax, pp,
                               sum(strat.micro_batches))

    def _solve_pipe(self, pipe: Sequence[int], gtimes: List[float],
                    tp: int, pp: int) -> Tuple[List[int], float]:
        """Layer partition + bottleneck time of ONE pipeline, memoized by
        the STAGE-ORDERED group-times tuple (order matters: the returned
        stage_layers align with stages) — swaps re-solve only the two
        touched pipelines."""
        per_layer = self._per_layer_cost(tp)
        stimes = tuple(gtimes[g] * per_layer for g in pipe[:pp])
        hit = self._pipe_cache.get(stimes)
        if hit is None:
            hit = _partition_layers(self.num_layers, list(stimes))
            self._pipe_cache[stimes] = hit
        return hit

    def _finish_eval(self, stage_layers, pipe_tmax, pp: int, dp: int):
        total_mb = self.M * dp
        mb = _apportion(total_mb, [1.0 / t for t in pipe_tmax]) \
            if dp > 1 else [total_mb]
        step = self._step_time(mb, pipe_tmax, pp, total_mb)
        return stage_layers, pipe_tmax, mb, float(step)

    def _eval_assignment(self, pipelines: List[List[int]],
                         gtimes: List[float], tp: int, pp: int, dp: int):
        """(stage_layers, pipe_tmax, mb, step) of one group->pipeline
        assignment: per-pipeline layer partition (slower stages get fewer
        layers) + Malleus micro-batch apportionment."""
        solved = [self._solve_pipe(p, gtimes, tp, pp) for p in pipelines]
        return self._finish_eval([s[0] for s in solved],
                                 [s[1] for s in solved], pp, dp)

    def _solve_one(self, tp: int, pp: int, dp: int,
                   groups: List[List[int]], gtimes: List[float]
                   ) -> Optional[Strategy]:
        if pp > self.num_layers:
            return None
        # Assign TP groups to pipelines: the reference ENUMERATES pp
        # patterns and solves arrangements (enumerate_pp_pattern,
        # strategy.py:562).  Equivalent search here: three seed patterns
        # over the speed-sorted groups —
        #   round-robin: every pipeline gets a speed mix,
        #   blocked:     stragglers quarantined into one slow pipeline
        #                (which then receives few micro-batches),
        #   snake:       boustrophedon balance of group sums —
        # each refined by pairwise-swap local search under the TRUE step
        # objective (layer partition + apportionment re-solved per move).
        order = sorted(range(len(groups)), key=lambda g: gtimes[g])

        def rr():
            ps = [[] for _ in range(dp)]
            for i, g in enumerate(order):
                ps[i % dp].append(g)
            return ps

        def blocked():
            return [order[p * pp:(p + 1) * pp] for p in range(dp)]

        def snake():
            ps = [[] for _ in range(dp)]
            for i, g in enumerate(order):
                row, col = divmod(i, dp)
                ps[col if row % 2 == 0 else dp - 1 - col].append(g)
            return ps

        self._pipe_cache: Dict[Tuple, Tuple] = {}
        best = None
        # evaluation budget: the swap search is a refinement, not an
        # exhaustive enumeration — on big pods the seeds alone already
        # capture the quarantine-vs-mix tradeoff
        budget = 500
        for seed in (rr, blocked, snake):
            pipelines = seed()
            sl, tmax, mb, step = self._eval_assignment(
                pipelines, gtimes, tp, pp, dp)
            improved, rounds = True, 0
            while improved and rounds < 20 and budget > 0:
                improved = False
                rounds += 1

                def scan_swaps():
                    # returns False as soon as the budget runs dry so the
                    # whole (p1,p2,i1,i2) scan exits, not just the
                    # innermost loop
                    nonlocal sl, tmax, mb, step, improved, budget
                    for p1 in range(dp):
                        for p2 in range(p1 + 1, dp):
                            for i1 in range(pp):
                                for i2 in range(pp):
                                    a, b = (pipelines[p1][i1],
                                            pipelines[p2][i2])
                                    if gtimes[a] == gtimes[b]:
                                        continue  # no-op move
                                    if budget <= 0:
                                        return False
                                    budget -= 1
                                    pipelines[p1][i1], \
                                        pipelines[p2][i2] = b, a
                                    # only the two touched pipelines
                                    # re-solve
                                    r1 = self._solve_pipe(pipelines[p1],
                                                          gtimes, tp, pp)
                                    r2 = self._solve_pipe(pipelines[p2],
                                                          gtimes, tp, pp)
                                    sl2 = list(sl)
                                    tm2 = list(tmax)
                                    sl2[p1], tm2[p1] = r1
                                    sl2[p2], tm2[p2] = r2
                                    s2 = self._finish_eval(sl2, tm2, pp, dp)
                                    if s2[3] < step - 1e-12:
                                        sl, tmax, mb, step = s2
                                        improved = True
                                    else:
                                        pipelines[p1][i1], \
                                            pipelines[p2][i2] = a, b
                    return True

                if not scan_swaps():
                    break
            if best is None or step < best[4]:
                best = ([list(p) for p in pipelines], sl, tmax, mb, step)
        pipelines, stage_layers, pipe_tmax, mb, step = best
        # device order: pipeline-major, stage-major, tp-minor — mesh axes
        # (pp, dp, tp) expect stage-outermost ordering
        device_order: List[int] = []
        for s in range(pp):
            for p in range(dp):
                g = pipelines[p][s]
                device_order.extend(groups[g])
        return Strategy(tp=tp, pp=pp, dp=dp, device_order=device_order,
                        stage_layers=stage_layers, micro_batches=mb,
                        est_step_time=float(step),
                        tp_group_times=[gtimes[g] for p in pipelines
                                        for g in p])
