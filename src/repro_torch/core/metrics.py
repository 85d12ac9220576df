"""Metrics: a zero-dependency observability plane for the cluster (§9).

The registry is deliberately tiny: counters, gauges, bounded-bucket
latency histograms and lightweight trace spans, all safe to touch from
the produce/fetch hot path.  Cost model:

* ``Counter.inc`` / ``Histogram.record`` — one short lock acquire plus
  integer arithmetic (~1µs under CPython).  Hot paths additionally guard
  timing blocks with ``registry.enabled`` so a disabled registry costs a
  single attribute load.
* ``Gauge`` values that are expensive to compute (producer-state table
  size, metadata apply lag, consumer lag) are registered as *callbacks*
  via :meth:`MetricsRegistry.gauge_fn` and evaluated only at snapshot /
  render time — they never touch the hot path.
* Histograms use fixed geometric buckets (1µs … ~67s, factor 2), so a
  record is an index computation plus one list increment; p50/p99 are
  estimated from bucket upper bounds at snapshot time.

Series are identified Prometheus-style: ``name{label="value",...}``.
``MetricsRegistry.snapshot()`` returns a JSON-safe dict (the payload the
``MetricsReporter`` daemon publishes to the replicated ``__metrics``
topic) and ``render_text()`` emits a Prometheus-compatible text dump for
humans and CI artifacts.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Any, Callable, Iterable

from repro_torch.analysis.witness import make_lock

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "METRICS_TOPIC",
    "default_registry",
    "series_key",
]

# Internal replicated topic the MetricsReporter publishes snapshots to.
METRICS_TOPIC = "__metrics"

# Geometric histogram bucket upper bounds: 1µs .. ~67s, factor 2, then +inf.
_BUCKETS: tuple[float, ...] = tuple(1e-6 * (2.0**i) for i in range(27)) + (
    math.inf,
)


def series_key(name: str, labels: dict[str, Any] | None = None) -> str:
    """Canonical series id: ``name`` or ``name{k="v",...}`` (sorted keys)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter."""

    __slots__ = ("key", "_lock", "_value")

    def __init__(self, key: str):
        self.key = key
        self._lock = make_lock("metrics", name=f"metrics:{key}")
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("key", "_lock", "_value")

    def __init__(self, key: str):
        self.key = key
        self._lock = make_lock("metrics", name=f"metrics:{key}")
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Bounded-bucket histogram (geometric buckets, seconds-oriented).

    Tracks count/sum/min/max exactly; percentiles are estimated as the
    upper bound of the bucket containing the requested rank, which for
    factor-2 buckets bounds the error at 2x — plenty for p50/p99 latency
    dashboards, and it keeps ``record`` O(1) with O(28) fixed memory.

    ``sample`` (a power of two) turns on hot-path sampling: after a
    64-observation warm-up every ``sample``-th value is recorded and the
    rest return after one unlocked integer update. Produce/append
    latency distributions are stationary over thousands of batches, so a
    1-in-8 sample leaves p50/p99 statistically unchanged while cutting
    the per-batch cost to a fraction of the ≤5% overhead budget
    (DESIGN.md §9); counters stay exact, so throughput accounting never
    samples.
    """

    __slots__ = ("key", "_lock", "_counts", "_count", "_sum", "_min",
                 "_max", "_tick", "_sample_mask")

    def __init__(self, key: str, sample: int = 1):
        self.key = key
        self._lock = make_lock("metrics", name=f"metrics:{key}")
        self._counts = [0] * len(_BUCKETS)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._tick = 0
        self._sample_mask = sample - 1  # sample is a power of two

    def record(self, value: float) -> None:
        if self._sample_mask:
            # unlocked tick: sampling is a rate heuristic, a lost update
            # under the GIL only nudges the effective rate
            t = self._tick = self._tick + 1
            if (t & self._sample_mask) and self._count >= 64:
                return
        # index of first bucket whose upper bound >= value
        if value <= 1e-6:
            idx = 0
        else:
            idx = min(
                int(math.log2(value / 1e-6)) + 1, len(_BUCKETS) - 1
            )
            if value > _BUCKETS[idx]:  # guard fp edge cases
                idx = min(idx + 1, len(_BUCKETS) - 1)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Estimated p-quantile (0 < p <= 1) from bucket upper bounds."""
        with self._lock:
            if self._count == 0:
                return 0.0
            rank = max(1, math.ceil(p * self._count))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    # the +inf bucket reports the exact observed max
                    if math.isinf(_BUCKETS[i]):
                        return self._max
                    return min(_BUCKETS[i], self._max)
            return self._max

    def stats(self) -> dict[str, float]:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            snap_counts = list(self._counts)
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        out = {
            "count": count,
            "sum": total,
            "min": lo,
            "max": hi,
            "mean": total / count,
        }
        for p, label in ((0.5, "p50"), (0.99, "p99")):
            rank = max(1, math.ceil(p * count))
            seen = 0
            for i, c in enumerate(snap_counts):
                seen += c
                if seen >= rank:
                    out[label] = hi if math.isinf(_BUCKETS[i]) else min(
                        _BUCKETS[i], hi
                    )
                    break
        return out


class Span:
    """Lightweight trace span with named phases.

    ``phase(name)`` closes the running segment and records it into the
    ``<span>_<phase>_seconds`` histogram; ``end()`` records the total
    into ``<span>_seconds`` and remembers the span in the registry's
    bounded recent-span buffer for inspection/tests.
    """

    __slots__ = ("name", "labels", "_registry", "_t0", "_last", "phases", "_done")

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        labels: dict[str, Any] | None = None,
    ):
        self.name = name
        self.labels = dict(labels or {})
        self._registry = registry
        self._t0 = time.perf_counter()
        self._last = self._t0
        self.phases: list[tuple[str, float]] = []
        self._done = False

    def phase(self, phase_name: str) -> float:
        now = time.perf_counter()
        dur = now - self._last
        self._last = now
        self.phases.append((phase_name, dur))
        self._registry.histogram(
            f"{self.name}_{phase_name}_seconds"
        ).record(dur)
        return dur

    def end(self, outcome: str = "ok") -> float:
        if self._done:
            return 0.0
        self._done = True
        total = time.perf_counter() - self._t0
        self._registry.histogram(f"{self.name}_seconds").record(total)
        self._registry._remember_span(
            {
                "span": self.name,
                "labels": self.labels,
                "outcome": outcome,
                "total_s": total,
                "phases": [
                    {"phase": p, "seconds": s} for p, s in self.phases
                ],
            }
        )
        return total

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end("error" if exc_type is not None else "ok")


class _NullSpan:
    """No-op span handed out by disabled registries."""

    __slots__ = ()
    phases: list = []

    def phase(self, phase_name: str) -> float:
        return 0.0

    def end(self, outcome: str = "ok") -> float:
        return 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_SPAN = _NullSpan()


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram | None):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._hist is not None:
            self._hist.record(time.perf_counter() - self._t0)


class MetricsRegistry:
    """Thread-safe registry of named metric series.

    ``enabled=False`` turns every accessor into a near-free no-op (hot
    paths also guard timing blocks on :attr:`enabled`); this is what the
    observability benchmark pairs an instrumented cluster against.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        # snapshot() reads series values (their leaf locks) under this,
        # hence the distinct just-below-leaf class (repro.analysis.ranks)
        self._lock = make_lock("metrics-registry")
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._gauge_fns: dict[str, Callable[[], float]] = {}
        self._spans: deque[dict[str, Any]] = deque(maxlen=256)
        # shared no-op instances for the disabled fast path
        self._null_counter = Counter("__disabled__")
        self._null_gauge = Gauge("__disabled__")
        self._null_histogram = Histogram("__disabled__")

    # -- accessors ---------------------------------------------------

    def counter(self, name: str, **labels: Any) -> Counter:
        if not self.enabled:
            return self._null_counter
        key = series_key(name, labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(key))
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        if not self.enabled:
            return self._null_gauge
        key = series_key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(key))
        return g

    def histogram(
        self, name: str, *, sample: int = 1, **labels: Any
    ) -> Histogram:
        """``sample`` (power of two, set by the first creator of a
        series) enables 1-in-``sample`` hot-path sampling after a
        64-observation warm-up — see :class:`Histogram`."""
        if not self.enabled:
            return self._null_histogram
        key = series_key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(key, Histogram(key, sample=sample))
        return h

    def gauge_fn(
        self, name: str, fn: Callable[[], float], **labels: Any
    ) -> None:
        """Register a gauge evaluated lazily at snapshot/render time."""
        if not self.enabled:
            return
        with self._lock:
            self._gauge_fns[series_key(name, labels)] = fn

    def timer(self, name: str, **labels: Any) -> _Timer:
        if not self.enabled:
            return _Timer(None)
        return _Timer(self.histogram(name, **labels))

    def span(self, name: str, **labels: Any) -> Span | _NullSpan:
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, labels)

    def _remember_span(self, record: dict[str, Any]) -> None:
        with self._lock:
            self._spans.append(record)

    def recent_spans(self, name: str | None = None) -> list[dict[str, Any]]:
        with self._lock:
            spans = list(self._spans)
        if name is None:
            return spans
        return [s for s in spans if s["span"] == name]

    # -- introspection helpers --------------------------------------

    def counter_value(self, name: str, **labels: Any) -> int:
        c = self._counters.get(series_key(name, labels))
        return c.value if c is not None else 0

    def gauge_value(self, name: str, **labels: Any) -> float:
        key = series_key(name, labels)
        g = self._gauges.get(key)
        if g is not None:
            return g.value
        fn = self._gauge_fns.get(key)
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return 0.0
        return 0.0

    # -- export ------------------------------------------------------

    def _collect_gauge_fns(self) -> dict[str, float]:
        with self._lock:
            fns = dict(self._gauge_fns)
        out: dict[str, float] = {}
        for key, fn in fns.items():
            try:
                out[key] = float(fn())
            except Exception:
                # a dead callback (e.g. broker being torn down) must not
                # poison the whole snapshot
                continue
        return out

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe point-in-time dump of every series."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = dict(self._histograms)
        return {
            "ts": time.time(),
            "counters": counters,
            "gauges": {**gauges, **self._collect_gauge_fns()},
            "histograms": {k: h.stats() for k, h in hists.items()},
        }

    def render_text(self) -> str:
        """Prometheus-style text exposition (zero dependencies)."""
        snap = self.snapshot()
        lines: list[str] = []

        def base_name(key: str) -> str:
            return key.split("{", 1)[0]

        seen_types: set[str] = set()
        for key in sorted(snap["counters"]):
            b = base_name(key)
            if b not in seen_types:
                seen_types.add(b)
                lines.append(f"# TYPE {b} counter")
            lines.append(f"{key} {snap['counters'][key]}")
        for key in sorted(snap["gauges"]):
            b = base_name(key)
            if b not in seen_types:
                seen_types.add(b)
                lines.append(f"# TYPE {b} gauge")
            lines.append(f"{key} {_fmt(snap['gauges'][key])}")
        for key in sorted(snap["histograms"]):
            stats = snap["histograms"][key]
            b = base_name(key)
            if b not in seen_types:
                seen_types.add(b)
                lines.append(f"# TYPE {b} summary")
            name, _, labels = key.partition("{")
            labels = ("{" + labels) if labels else ""
            lines.append(f"{name}_count{labels} {stats['count']}")
            lines.append(f"{name}_sum{labels} {_fmt(stats['sum'])}")
            for q in ("p50", "p99"):
                if q in stats:
                    lines.append(f"{name}_{q}{labels} {_fmt(stats[q])}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def decode_snapshot(payload: bytes) -> dict[str, Any]:
        """Decode one ``__metrics`` record back into a snapshot dict."""
        return json.loads(payload.decode("utf-8"))

    def encode_snapshot(self) -> bytes:
        return json.dumps(self.snapshot(), sort_keys=True).encode("utf-8")


def _fmt(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


# Process-wide registry for components that have no cluster to hang a
# registry off (data-pipeline daemons: prefetch workers, device_feed).
# Cluster-scoped series stay on the cluster's own registry.
_default_registry: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    global _default_registry
    if _default_registry is None:
        _default_registry = MetricsRegistry()
    return _default_registry
