"""Elastic training (Malleus; counterpart of ``hetu_tpu.elastic``):
straggler profiling, the heterogeneity-aware strategy solver, the SPMD
``Trainer`` that profiles, re-solves and hot-switches the graph between
parallel layouts (``parallel.switch``), and the fault plane
(``FaultTolerantTrainer``, ``TrainBuild``, ``WorkerMonitor``: checkpoint,
detect, re-plan, verified restore, and the numeric sentry's ladder).

The JAX package's ``ElasticMPMDTrainer`` (item 11b: rank processes for a
MPMD stage) is not ported; asking this package for it raises
``NotImplementedError`` naming the item.
"""
from .ft import (TRAINER_COUNTERS, FaultTolerantTrainer, TrainBuild,
                 WorkerMonitor, write_recovery_report)
from .straggler import Straggler, StragglerWorkload
from .strategy import Strategy, StrategyModel
from .trainer import Trainer

__all__ = ["FaultTolerantTrainer", "Straggler", "StragglerWorkload",
           "Strategy", "StrategyModel", "TRAINER_COUNTERS", "TrainBuild",
           "Trainer", "WorkerMonitor", "write_recovery_report"]

_LATER = {
    "ElasticMPMDTrainer": "item 11b (rank processes for a MPMD stage)",
}


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"hetu_tpu_torch.elastic.{name} is ported in ROADMAP queue 1 "
            f"{_LATER[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
