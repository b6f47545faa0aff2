"""Leveled logging + wall-clock timing macros.

Counterpart of the reference's ``hetu/common/logging.h`` (TRACE..FATAL
streams gated by ``HETU_INTERNAL_LOG_LEVEL``) and ``timing.h`` (TIK/TOK
wall timing).  Level env: ``HETU_TPU_LOG_LEVEL`` in
TRACE/DEBUG/INFO/WARN/ERROR/FATAL (the JAX package's variable: one
setting serves both packages).
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Optional

ENV_LOG_LEVEL = "HETU_TPU_LOG_LEVEL"

_LEVELS = {"TRACE": 5, "DEBUG": logging.DEBUG, "INFO": logging.INFO,
           "WARN": logging.WARNING, "ERROR": logging.ERROR,
           "FATAL": logging.CRITICAL}

logging.addLevelName(5, "TRACE")

_loggers: Dict[str, logging.Logger] = {}


def get_logger(name: str = "hetu_tpu_torch") -> logging.Logger:
    if name in _loggers:
        return _loggers[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(levelname)s %(asctime)s %(name)s] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.propagate = False
    level_name = os.environ.get(ENV_LOG_LEVEL, "WARN").upper()
    logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
    _loggers[name] = logger
    return logger


def set_log_level(level: str, name: str = "hetu_tpu_torch") -> None:
    get_logger(name).setLevel(_LEVELS[level.upper()])


# -- TIK/TOK (reference hetu/common/timing.h) -------------------------------

_timers: Dict[str, float] = {}


def TIK(tag: str = "default") -> None:
    _timers[tag] = time.perf_counter()


def TOK(tag: str = "default", log: bool = False) -> float:
    """Seconds since the matching TIK; optionally logs at INFO."""
    if tag not in _timers:
        raise KeyError(f"TOK({tag!r}) without TIK")
    dt = time.perf_counter() - _timers[tag]
    if log:
        get_logger().info("%s: %.3f ms", tag, dt * 1e3)
    return dt


class Timer:
    """Context-manager timer: ``with Timer() as t: ...; t.seconds``."""

    def __init__(self, tag: str = ""):
        self.tag = tag
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
