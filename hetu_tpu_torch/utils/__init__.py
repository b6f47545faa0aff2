"""Utilities of the port (``hetu_tpu.utils`` counterpart): logging and
timing, step and memory profilers, checkpoints (``utils.checkpoint``)
and the serving metrics (``utils.metrics``)."""
from .logging_utils import TIK, TOK, Timer, get_logger, set_log_level
from .profiler import (MemoryProfiler, OpProfiler, StepProfiler,
                       device_memory_stats)

__all__ = ["TIK", "TOK", "Timer", "get_logger", "set_log_level",
           "MemoryProfiler", "OpProfiler", "StepProfiler",
           "device_memory_stats"]
