"""Serving telemetry: the typed metrics registry (port of the metrics part
of ``repro.runtime.telemetry``).

Named counters, gauges and histograms that the engine registers into;
``Server.last_stats`` is regenerated from the registry as a flat view, so
the reference's key names carry over.  ``begin_serve()`` drops per-serve
metrics; lifetime metrics opt out with ``persist=True``.  The lifecycle
tracer and its exporters come later.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TelemetryConfig:
    """Per-server telemetry switches.

    trace:        record lifecycle + engine-step events (not ported yet).
    jax_profiler: the reference's profiler annotations (not ported).
    max_events:   tracer ring cap.
    """

    trace: bool = False
    jax_profiler: bool = False
    max_events: int = 1_000_000


class Counter:
    """Monotone per-serve (or lifetime, with persist=True) counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", persist: bool = False):
        self.name = name
        self.help = help
        self.persist = persist
        self.value = 0.0

    def add(self, v: float = 1.0) -> None:
        self.value += float(v)

    def set_to(self, v: float) -> None:
        """Republish a lifetime total (monotone: never moves backwards)."""
        self.value = max(self.value, float(v))

    def view(self) -> Dict[str, float]:
        return {self.name: self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", persist: bool = False):
        self.name = name
        self.help = help
        self.persist = persist
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def view(self) -> Dict[str, float]:
        return {self.name: self.value}


#: Default histogram bucket upper bounds, in output units (after ``scale``).
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(2.0 ** e for e in range(-6, 16))


class Histogram:
    """Fixed-bucket histogram with exact quantiles while samples are
    retained (``np.percentile`` over the raw samples); past
    ``max_samples`` quantiles interpolate within the buckets."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        persist: bool = False,
        quantiles: Sequence[float] = (50, 95, 99),
        scale: float = 1.0,
        suffix: str = "",
        buckets: Optional[Sequence[float]] = None,
        max_samples: int = 65536,
    ):
        self.name = name
        self.help = help
        self.persist = persist
        self.quantiles = tuple(quantiles)
        self.scale = float(scale)
        self.suffix = suffix
        self.buckets = (tuple(buckets) if buckets is not None
                        else DEFAULT_BUCKETS)
        self.max_samples = int(max_samples)
        self.bucket_counts = np.zeros(len(self.buckets) + 1, dtype=np.int64)
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0  # in output units

    def observe(self, v: float) -> None:
        out = float(v) * self.scale
        self.bucket_counts[int(np.searchsorted(self.buckets, out))] += 1
        self.count += 1
        self.total += out
        if len(self.samples) < self.max_samples:
            self.samples.append(float(v))

    @property
    def exact(self) -> bool:
        return self.count == len(self.samples)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if self.exact:
            return float(np.percentile(np.asarray(self.samples), q)
                         * self.scale)
        return self._bucket_quantile(q)

    def _bucket_quantile(self, q: float) -> float:
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            nxt = cum + int(c)
            if nxt >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1] * 2.0)
                frac = (target - cum) / max(int(c), 1)
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum = nxt
        return float(self.buckets[-1])

    def key(self, q: float) -> str:
        return f"{self.name}_p{int(q)}{self.suffix}"

    def view(self) -> Dict[str, float]:
        return {self.key(q): self.quantile(q) for q in self.quantiles}


class MetricsRegistry:
    """Ordered get-or-create registry of typed metrics."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind: str, factory) -> Any:
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {kind}")
            return m
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                persist: bool = False) -> Counter:
        return self._get(name, "counter", lambda: Counter(name, help, persist))

    def gauge(self, name: str, help: str = "", persist: bool = False) -> Gauge:
        return self._get(name, "gauge", lambda: Gauge(name, help, persist))

    def histogram(self, name: str, help: str = "", persist: bool = False,
                  **kw) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(name, help, persist, **kw))

    def begin_serve(self) -> None:
        """Drop every per-serve metric so stale dynamic keys cannot leak."""
        self._metrics = {k: m for k, m in self._metrics.items() if m.persist}

    def flat_view(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            out.update(m.view())
        return out
