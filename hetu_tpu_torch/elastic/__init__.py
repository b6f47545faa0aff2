"""Elastic training (Malleus; counterpart of ``hetu_tpu.elastic``):
straggler profiling, the heterogeneity-aware strategy solver, and the
SPMD ``Trainer`` that profiles, re-solves and hot-switches the graph
between parallel layouts (``parallel.switch``).

The JAX package's fault plane (``FaultTolerantTrainer``, ``TrainBuild``,
``WorkerMonitor``: ROADMAP queue 1 item 15, it needs ``resilience``) and
its ``ElasticMPMDTrainer`` (item 11b: rank processes for a MPMD stage) are
not ported; asking this package for them raises ``NotImplementedError``
naming the item.
"""
from .straggler import Straggler, StragglerWorkload
from .strategy import Strategy, StrategyModel
from .trainer import Trainer

__all__ = ["Straggler", "StragglerWorkload", "Strategy", "StrategyModel",
           "Trainer"]

_LATER = {
    "FaultTolerantTrainer": "item 15 (the fault plane needs resilience)",
    "TrainBuild": "item 15 (the fault plane needs resilience)",
    "WorkerMonitor": "item 15 (the fault plane needs resilience)",
    "ElasticMPMDTrainer": "item 11b (rank processes for a MPMD stage)",
}


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"hetu_tpu_torch.elastic.{name} is ported in ROADMAP queue 1 "
            f"{_LATER[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
