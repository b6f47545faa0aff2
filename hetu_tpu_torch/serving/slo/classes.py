"""SLO classes: the request-priority vocabulary of the traffic plane
(copy of ``hetu_tpu.serving.slo.classes``).

Three classes, strictly rank-ordered: ``interactive`` (tight TTFT/TBT,
packed first), ``standard`` (the default) and ``batch`` (no latency
promise; absorbs preemption and queueing).  Rank is policy only: it
decides which request waits or is preempted, never what a surviving
request computes.  Per-class latency targets (``DEFAULT_TARGETS``)
feed the autoscaler, which scales up when interactive TTFT crosses its
target.
"""
from __future__ import annotations

from typing import Dict

# strict rank order: index IS the priority (lower = more urgent)
SLO_CLASSES = ("interactive", "standard", "batch")

CLASS_RANK: Dict[str, int] = {c: i for i, c in enumerate(SLO_CLASSES)}

#: per-class latency targets (seconds): TTFT = submit -> first token,
#: TBT = gap between consecutive tokens.  ``None`` = no promise.
DEFAULT_TARGETS: Dict[str, Dict[str, float]] = {
    "interactive": {"ttft_s": 0.5, "tbt_s": 0.1},
    "standard": {"ttft_s": 2.0, "tbt_s": 0.5},
    "batch": {"ttft_s": None, "tbt_s": None},
}


def class_rank(slo_class: str) -> int:
    """Priority rank of ``slo_class`` (0 = most urgent).  Raises on an
    unknown class."""
    try:
        return CLASS_RANK[slo_class]
    except KeyError:
        raise ValueError(f"unknown slo_class {slo_class!r}; "
                         f"have {SLO_CLASSES}") from None
