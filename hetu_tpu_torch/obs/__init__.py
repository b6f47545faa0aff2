"""Runtime trace plane (port of ``hetu_tpu.obs``): the span tracer and its
exporters.

:mod:`.tracer` records low-overhead structured spans (monotonic clock,
parent/child nesting, instant events, capped ring buffer, thread-safe)
with a shared no-op ``NULL_TRACER``, so disabled tracing costs almost
nothing in the hot loops.  The engine (per-request lifecycle, packing,
unified steps, host-tier moves), the serving cluster (routing, handoffs,
faults and recovery), ``DefineAndRunGraph.run`` (a ``train_step`` span
with ``feed``, ``executable`` and ``commit`` children), ``switch_strategy``
and the fault-tolerant trainer emit into it.  :mod:`.export` writes
Chrome trace-event JSON (Perfetto) and a JSONL journal and groups the
serving events by request.  The JAX package's ``obs/reconcile.py`` joins
the trace to the analysis plane's predictions and waits for it (ROADMAP
queue 1 item 18).
"""
from .export import (chrome_trace, events_to_jsonl, request_timelines,
                     timeline_summary, validate_chrome_trace,
                     write_chrome_trace, write_jsonl)
from .tracer import (NOOP_SPAN, NULL_TRACER, PrefixedTracer, Span,
                     SpanTracer, get_tracer, install_tracer, trace)

__all__ = ["Span", "SpanTracer", "PrefixedTracer", "NULL_TRACER",
           "NOOP_SPAN", "get_tracer", "install_tracer", "trace",
           "chrome_trace", "write_chrome_trace", "events_to_jsonl",
           "write_jsonl", "validate_chrome_trace", "request_timelines",
           "timeline_summary"]
