"""Planner (port of ``hetu_tpu.planner``, in part): the cost model's
chip and cluster specs and collective formulas, H100 SXM by default.
The solver, search and profiling come with ROADMAP queue 1 item 16."""
from .cost_model import (ChipSpec, ClusterSpec, all_gather_time,
                         all_reduce_time, all_to_all_time, collective_time,
                         p2p_time, reduce_scatter_time)

__all__ = ["ChipSpec", "ClusterSpec", "all_gather_time",
           "all_reduce_time", "all_to_all_time", "collective_time",
           "p2p_time", "reduce_scatter_time"]
