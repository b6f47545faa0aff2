"""Class-aware cluster backlog: one arrival-ordered heap per SLO class
(port of ``hetu_tpu.serving.slo.backlog``, pure Python).

Under a mixed-priority workload a single FIFO front door is exactly the
wrong policy: a burst of batch arrivals ahead of one interactive
request delays the interactive TTFT by the whole burst.
:class:`ClassBacklog` keeps the per-class FIFO
(arrival order within a class — starvation-free, no same-class
overtaking) but serves classes rank-major: an *arrived* interactive
request always routes before an arrived batch one, and a future
arrival in a high class never gates an arrived low one (each class has
its own arrival-time head, mirroring ``serving.request.RequestQueue``).

Shedding is rank-aware in the other direction: capacity pressure
(``max_backlog``, deadlines) falls on the LOWEST class first —
:meth:`shed_candidate` names the latest-arrived entry of the
lowest-priority non-empty class, and :meth:`expired_head` scans class
heads batch-first — so backpressure sheds batch before it ever delays
(or drops) interactive.

Iteration yields ``(arrival_time, req_id, creq)`` triples (rank-major,
arrival order within a class), the shape the chaos invariant sweep
reads.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, Optional

from .classes import SLO_CLASSES


class ClassBacklog:
    """Per-class min-heaps on ``(arrival_time, req_id)``."""

    def __init__(self):
        self._heaps: Dict[str, list] = {c: [] for c in SLO_CLASSES}

    def push(self, creq) -> None:
        heapq.heappush(self._heaps[creq.slo_class],
                       (creq.arrival_time, creq.req_id, creq))

    def peek_ready(self, now: float):
        """The next request to route: rank-major over classes, FIFO
        within one, gated on arrival — a future interactive never
        blocks an arrived batch."""
        for c in SLO_CLASSES:
            heap = self._heaps[c]
            if heap and heap[0][0] <= now:
                return heap[0][2]
        return None

    def remove(self, creq) -> None:
        """Drop a specific entry (a routed head, or a shed victim —
        backlogs are small and bounded, the O(n) scan is fine)."""
        heap = self._heaps[creq.slo_class]
        for i, (_arr, rid, _c) in enumerate(heap):
            if rid == creq.req_id:
                heap[i] = heap[-1]
                heap.pop()
                heapq.heapify(heap)
                return
        raise KeyError(creq.req_id)

    # -- shed policy ----------------------------------------------------------

    def shed_candidate(self):
        """Who a full backlog should displace: the latest-arrived entry
        of the lowest-priority non-empty class.  The caller sheds it
        only when the incoming request STRICTLY outranks it; same-class
        pressure sheds the arrival instead."""
        for c in reversed(SLO_CLASSES):
            heap = self._heaps[c]
            if heap:
                return max(heap)[2]
        return None

    def expired_head(self, now: float, deadline: Optional[float]):
        """An arrived class head waiting past ``deadline``, lowest
        class first — when the whole fleet is backpressured, batch
        sheds before standard before interactive."""
        if deadline is None:
            return None
        for c in reversed(SLO_CLASSES):
            heap = self._heaps[c]
            if heap and heap[0][0] <= now \
                    and now - heap[0][2].submit_time > deadline:
                return heap[0][2]
        return None

    # -- introspection --------------------------------------------------------

    def depth_by_class(self,
                       now: Optional[float] = None) -> Dict[str, int]:
        """Queue depth per class; with ``now``, only ARRIVED entries
        count — a future-dated arrival is scheduled traffic, not
        pressure (the autoscaler must not hold capacity for it)."""
        if now is None:
            return {c: len(h) for c, h in self._heaps.items()}
        return {c: sum(1 for arr, _r, _q in h if arr <= now)
                for c, h in self._heaps.items()}

    def __len__(self) -> int:
        return sum(len(h) for h in self._heaps.values())

    def __bool__(self) -> bool:
        return any(self._heaps.values())

    def __iter__(self) -> Iterator:
        """Rank-major ``(arrival_time, req_id, creq)`` triples (the
        shape the chaos invariants unpack)."""
        for c in SLO_CLASSES:
            for item in sorted(self._heaps[c]):
                yield item
