"""Runtime trace plane (port of ``hetu_tpu.obs``): the span tracer.

:mod:`.tracer` records low-overhead structured spans (monotonic clock,
parent/child nesting, instant events, capped ring buffer, thread-safe)
with a shared no-op ``NULL_TRACER``, so disabled tracing costs almost
nothing in the serving hot loop.  The engine (per-request lifecycle,
packing, unified steps, host-tier moves) and the serving cluster
(routing, handoffs, faults and recovery) emit into it.  The exporters
(``obs/export.py``, ``obs/reconcile.py``) come with the runtime planes
(ROADMAP queue 1 item 15).
"""
from .tracer import (NOOP_SPAN, NULL_TRACER, PrefixedTracer, Span,
                     SpanTracer, get_tracer, install_tracer, trace)

__all__ = ["Span", "SpanTracer", "PrefixedTracer", "NULL_TRACER",
           "NOOP_SPAN", "get_tracer", "install_tracer", "trace"]
