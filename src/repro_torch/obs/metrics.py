"""Serving metrics registry: counters / gauges / fixed-bucket histograms.

One :class:`MetricsRegistry` per engine is the single source of truth
for every number ``report()`` and ``health()`` expose.  The engine's
historical ``self.metrics`` dict survives as :class:`MetricsDict`, a
``MutableMapping`` facade whose items are registry counters — so every
existing call site (``self.metrics["gen_tokens"] += 1`` in the engine,
``metrics.setdefault(...)`` in the scheduler) keeps working unchanged
while the values live in exactly one place.

Exposition formats:

* ``to_prometheus()`` — the text format scrape endpoints speak
  (``# TYPE`` lines, ``_bucket{le=...}`` cumulative histograms);
  served by ``repro_torch.obs.http`` under ``/metrics``;
* ``snapshot()`` — a NaN-free JSON-ready dict.

Like ``obs.trace`` this module imports no torch and must never block on a
device: every recorded value is a plain host float.
"""
from __future__ import annotations

from collections import deque
from collections.abc import MutableMapping
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsDict", "LATENCY_BUCKETS_MS"]

#: default latency buckets (milliseconds): wide enough for queue waits
#: on a loaded server, fine enough to place a 2-40ms ITL.
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def _valid_name(name: str) -> str:
    ok = all(c.isalnum() or c in "_:" for c in name) and name \
        and not name[0].isdigit()
    if not ok:
        raise ValueError(f"invalid metric name {name!r} "
                         "(expected [a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


class Counter:
    """Monotonic-by-convention scalar.  ``set`` exists because the
    engine's windowed figures (``reset_dispatch_window``) rewind their
    counters to scope a measurement — our registry allows it and the
    Prometheus scraper sees it as a counter reset, which scrape-side
    ``rate()`` already handles."""
    __slots__ = ("name", "help", "_value")
    prom_type = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _valid_name(name)
        self.help = help
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    def set(self, v: float) -> None:
        self._value = float(v)

    def get(self) -> float:
        return self._value


class Gauge(Counter):
    """A scalar that goes both ways (queue depth, EMA, pool pressure)."""
    __slots__ = ()
    prom_type = "gauge"


class Histogram:
    """Fixed-bucket cumulative histogram with an optional bounded
    raw-sample window.

    Buckets are upper bounds (``value <= bound`` lands in the bucket,
    Prometheus ``le`` semantics) plus an implicit ``+Inf``.  The bucket
    counts / sum / count are cumulative forever (what ``/metrics``
    exports); the raw-sample deque — bounded at ``sample_maxlen`` — is
    the *percentile window*: ``percentile()`` reads it exactly, and
    ``clear_samples()`` re-scopes it (``engine.reset_itl_window``)
    without disturbing the cumulative series.
    """
    __slots__ = ("name", "help", "buckets", "counts", "sum", "count",
                 "_samples")
    prom_type = "histogram"

    def __init__(self, name: str, buckets: Sequence[float],
                 help: str = "", sample_maxlen: int = 8192):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be ascending, got {buckets!r}")
        self.name = _valid_name(name)
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._samples: Optional[deque] = \
            deque(maxlen=int(sample_maxlen)) if sample_maxlen else None

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.buckets:                 # tiny fixed loop; no deps
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        if self._samples is not None:
            self._samples.append(v)

    # ------------------------------------------------------------ reads
    def samples(self) -> List[float]:
        return list(self._samples or ())

    def clear_samples(self) -> None:
        """Re-scope the percentile window (cumulative series untouched)."""
        if self._samples is not None:
            self._samples.clear()

    def percentile(self, p: float) -> float:
        """Exact percentile over the bounded sample window (NaN when
        empty) — linear interpolation, matching ``numpy.percentile``."""
        xs = sorted(self._samples or ())
        if not xs:
            return float("nan")
        if len(xs) == 1:
            return xs[0]
        rank = (p / 100.0) * (len(xs) - 1)
        lo = int(rank)
        frac = rank - lo
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def cumulative(self) -> List[Tuple[str, int]]:
        """``(le, cumulative_count)`` pairs, ``+Inf`` last."""
        out = []
        acc = 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((format(b, "g"), acc))
        out.append(("+Inf", acc + self.counts[-1]))
        return out


class MetricsRegistry:
    """Named metrics, one namespace; get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help=help, **kw)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls) or type(m) is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, buckets: Sequence[float]
                  = LATENCY_BUCKETS_MS, help: str = "",
                  sample_maxlen: int = 8192) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets,
                                   sample_maxlen=sample_maxlen)

    def get(self, name: str):
        return self._metrics.get(name)

    def remove(self, name: str) -> None:
        self._metrics.pop(name, None)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # ------------------------------------------------------------ export
    def to_prometheus(self) -> str:
        """Text exposition format (version 0.0.4): what ``/metrics``
        serves and what ``promtool check metrics`` accepts."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.prom_type}")
            if isinstance(m, Histogram):
                for le, acc in m.cumulative():
                    lines.append(f'{name}_bucket{{le="{le}"}} {acc}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {m.get():g}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """NaN-free JSON-ready snapshot of every registered metric."""
        out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out["histograms"][name] = {
                    "count": m.count, "sum": m.sum,
                    "buckets": {le: acc for le, acc in m.cumulative()}}
            elif isinstance(m, Gauge):
                v = m.get()
                out["gauges"][name] = v if v == v else None   # NaN -> null
            else:
                out["counters"][name] = m.get()
        return out


class MetricsDict(MutableMapping):
    """Dict-shaped facade over registry counters.

    ``m["gen_tokens"] += 1`` reads and writes the registry counter
    ``<prefix>gen_tokens`` — the engine and scheduler keep their
    historical dict idiom (including ``setdefault``) while the registry
    stays the single source of truth.  Keys are the bare historical
    names; the prefix only namespaces the Prometheus exposition.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str = "repro_",
                 initial: Optional[Dict[str, float]] = None):
        self._reg = registry
        self._prefix = prefix
        self._by_key: Dict[str, Counter] = {}
        for k, v in (initial or {}).items():
            self[k] = v

    def metric(self, key: str) -> Counter:
        """The backing registry counter (creating it if needed)."""
        m = self._by_key.get(key)
        if m is None:
            m = self._reg.counter(self._prefix + key)
            self._by_key[key] = m
        return m

    def __getitem__(self, key: str) -> float:
        if key not in self._by_key:
            raise KeyError(key)
        return self._by_key[key].get()

    def __setitem__(self, key: str, value: float) -> None:
        self.metric(key).set(float(value))

    def __delitem__(self, key: str) -> None:
        m = self._by_key.pop(key)
        self._reg.remove(m.name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._by_key)

    def __len__(self) -> int:
        return len(self._by_key)
