"""Metrics (counterpart of ``hetu_tpu.utils.metrics``).

``Metrics``: a step-keyed recorder of scalar series with JSONL
persistence (the ring attention's per-round table is logged through
it).  The serving instruments: monotonically increasing counters,
point-in-time gauges and latency histograms, with a shared no-op
fallback so the engine's loop pays nothing when metrics are disabled,
plus Prometheus text exposition and the merge of several expositions
under one label (the serving cluster's view of its replicas)."""
from __future__ import annotations

import json
import os
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional


class Metrics:
    """Scalar time series: ``rec.log(step, loss=2.31)``, ``series(key)``;
    with ``log_file`` every ``log`` call appends one JSON line."""

    def __init__(self, log_file: Optional[str] = None):
        self._series: Dict[str, List[tuple]] = defaultdict(list)
        self._fh = None
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                        exist_ok=True)
            self._fh = open(log_file, "a")

    def log(self, step: int, **values: Any) -> None:
        clean = {k: float(v) for k, v in values.items()}
        for k, v in clean.items():
            self._series[k].append((int(step), v))
        if self._fh is not None:
            self._fh.write(json.dumps({"step": int(step), **clean}) + "\n")
            self._fh.flush()

    def series(self, key: str) -> List[tuple]:
        return list(self._series.get(key, ()))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def percentile_of(xs_sorted, p: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted sequence
    (numpy's default estimator; ``p`` in [0, 100])."""
    if not xs_sorted:
        return 0.0
    rank = max(0.0, min(100.0, float(p))) / 100.0 * (len(xs_sorted) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs_sorted) - 1)
    return xs_sorted[lo] + (xs_sorted[hi] - xs_sorted[lo]) * (rank - lo)


class Counter:
    """Monotonically increasing count (tokens generated, preemptions)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (queue depth, pool utilization)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Latency/size distribution with exact percentiles over a capped
    window of raw observations; optional Prometheus-style ``buckets``
    (sorted upper bounds, implicit ``+Inf``)."""

    __slots__ = ("name", "_obs", "count", "total", "buckets",
                 "_bucket_counts")

    def __init__(self, name: str = "", max_observations: int = 4096,
                 buckets: Optional[List[float]] = None):
        self.name = name
        self._obs = deque(maxlen=int(max_observations))
        self.count = 0
        self.total = 0.0
        self.buckets = tuple(sorted(float(b) for b in buckets)) \
            if buckets else ()
        # per-bucket (non-cumulative) tallies; slot -1 is +Inf overflow
        self._bucket_counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self._obs.append(v)
        self.count += 1
        self.total += v
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                self._bucket_counts[i] += 1
                break
        else:
            self._bucket_counts[-1] += 1

    def bucket_counts(self) -> Dict[str, int]:
        """Cumulative Prometheus-style ``{le: count}`` incl. ``+Inf``."""
        out: Dict[str, int] = {}
        cum = 0
        for bound, c in zip(self.buckets, self._bucket_counts):
            cum += c
            out[repr(bound)] = cum
        out["+Inf"] = cum + self._bucket_counts[-1]
        return out

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        return percentile_of(sorted(self._obs), p)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class _NullInstrument:
    """No-op stand-in for any instrument when metrics are disabled."""

    name = ""
    value = 0.0
    count = 0
    total = 0.0
    mean = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, p: float) -> float:
        return 0.0

    def bucket_counts(self) -> Dict[str, int]:
        return {"+Inf": 0}

    def summary(self) -> Dict[str, float]:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                "p99": 0.0}


NULL_INSTRUMENT = _NullInstrument()


def make_instrument(kind: str, name: str = "", enabled: bool = True,
                    **kwargs):
    """Factory with the disabled fallback (the shared no-op)."""
    if not enabled:
        return NULL_INSTRUMENT
    cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}.get(
        kind.lower())
    if cls is None:
        raise ValueError(f"unknown instrument kind {kind!r}")
    return cls(name, **kwargs)


def _prom_name(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _prom_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(instruments: Dict[str, object]) -> str:
    """Prometheus text exposition (v0.0.4) for ``{name: instrument}``.
    No-op instruments are skipped."""
    lines: List[str] = []
    for name, inst in instruments.items():
        if isinstance(inst, _NullInstrument):
            continue
        name = _prom_name(name)
        if isinstance(inst, Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_prom_value(inst.value)}")
        elif isinstance(inst, Gauge):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_prom_value(inst.value)}")
        elif isinstance(inst, Histogram):
            lines.append(f"# TYPE {name} histogram")
            for le, c in inst.bucket_counts().items():
                le_txt = le if le == "+Inf" else repr(float(le))
                lines.append(f'{name}_bucket{{le="{le_txt}"}} {int(c)}')
            lines.append(f"{name}_sum {_prom_value(inst.total)}")
            lines.append(f"{name}_count {int(inst.count)}")
    return "\n".join(lines) + "\n" if lines else ""


def merge_prometheus_texts(texts: Dict[str, str],
                           label: str = "replica") -> str:
    """Merge several Prometheus expositions into one, tagging every
    sample with ``label="<key>"`` — the cluster's ``metrics_text()``
    merges per-replica ``Engine.metrics_text()`` outputs this way, so
    one scrape endpoint serves the whole replica fleet and dashboards
    slice by the ``replica`` label.

    Samples are regrouped per metric (one ``# TYPE`` line per metric
    name, first-seen kind wins, then every labeled sample), which keeps
    the output a valid exposition: Prometheus requires all samples of a
    metric to be contiguous under its single TYPE header."""
    import re
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(.*)$")
    kinds: Dict[str, str] = {}
    samples: Dict[str, List[str]] = {}
    order: List[str] = []
    for key, text in texts.items():
        tag = f'{_prom_name(label)}="{key}"'
        for line in (text or "").splitlines():
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                parts = line.split()
                if len(parts) >= 4 and parts[1] == "TYPE":
                    kinds.setdefault(parts[2], parts[3])
                continue
            m = sample_re.match(line)
            if m is None:
                continue
            name, labels, value = m.groups()
            inner = (labels or "{}")[1:-1]
            labels = "{" + (f"{inner},{tag}" if inner else tag) + "}"
            # histogram series (_bucket/_sum/_count) group under the
            # base metric's TYPE header, like the scrape format expects
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in kinds:
                    base = name[:-len(suffix)]
                    break
            if base not in samples:
                samples[base] = []
                order.append(base)
            samples[base].append(f"{name}{labels} {value}")
    lines: List[str] = []
    for base in order:
        if base in kinds:
            lines.append(f"# TYPE {base} {kinds[base]}")
        lines.extend(samples[base])
    return "\n".join(lines) + "\n" if lines else ""
