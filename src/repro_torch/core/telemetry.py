"""Process-wide deterministic telemetry: counters, gauges, histograms, spans
(the port's copy of `repro.core.telemetry`, schema letter for letter).

Every latency claim in the paper is a *distribution* claim (bubble
fraction, TTFT, inter-token p99, recovery time), so the serving stack
records them through one registry instead of per-feature trace lists.
The design constraints, in order:

1. **Determinism.**  Two identical runs must produce byte-identical
   snapshots.  Time-valued quantities that can be accumulated from the
   streamer thread are stored as *integer nanoseconds* (float addition
   is order-sensitive; integer addition is not).  The modeled clock is
   only ever advanced from the serving thread, and spans are only
   opened/closed there, so span timings are plain floats.
2. **Near-free when disabled.**  Instrumented code calls the module
   helpers (`count`, `observe`, `span`, ...) which are a single `is
   None` check when no registry is installed — the same pattern as
   `dejavulib.faults`.
3. **Bounded memory.**  Histograms keep fixed log-spaced buckets and a
   ns-sum, never raw samples; spans aggregate by path (count/total/max),
   never individual events.

The snapshot is a versioned, JSON-stable schema (``repro.telemetry/v1``)
consumed by ``EngineReport.telemetry`` and by the repository's tools that
read the JAX package's snapshots (``tools/check_bench_trend.py``).
"""
from __future__ import annotations

import json
import math
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

SCHEMA = "repro.telemetry/v1"

# Default histogram bucket upper bounds, seconds.  Log-spaced from 1 us
# to 10 min: 4 buckets per decade is plenty for p50/p90/p99 bands while
# keeping snapshots small.  Samples above the last edge land in a final
# overflow bucket.
_DECADES = range(-6, 3)  # 1e-6 .. 1e2
DEFAULT_BUCKETS_S: Tuple[float, ...] = tuple(
    round(m * (10.0 ** d), 12) for d in _DECADES for m in (1.0, 2.0, 5.0)
) + (600.0,)

_NS = 1_000_000_000


def _ns(seconds: float) -> int:
    return int(round(seconds * _NS))


def _label_key(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    parts = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{parts}}}"


class Counter:
    """Monotonic integer counter (time counters accumulate nanoseconds)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, v: int = 1) -> None:
        self.value += int(v)


class Gauge:
    """Last-write-wins float value (set from the serving thread only)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: bucket counts + ns-sum + min/max.

    Quantiles are computed from bucket counts by linear interpolation
    inside the containing bucket, clamped to the observed [min, max] —
    deterministic, and never stores raw samples.
    """

    __slots__ = ("buckets", "counts", "count", "sum_ns", "min", "max")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS_S) -> None:
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 overflow bucket
        self.count = 0
        self.sum_ns = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.count += 1
        self.sum_ns += _ns(v)
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                frac = (target - cum) / c
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            cum += c
        return self.max


class Telemetry:
    """The registry: typed instruments plus the modeled clock.

    Instruments are keyed by ``name`` or ``name{k=v,...}`` (labels
    sorted).  All mutation goes through a lock; the hot-path cost is one
    dict lookup + one int add.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # span path -> [count, total_s, max_s]
        self._spans: Dict[str, List[float]] = {}
        self._tls = threading.local()
        self.clock_s = 0.0
        # determinism rule: the modeled clock and spans belong to the
        # thread that owns the registry (bound here, re-bound by
        # ``install``); `_check_owner` enforces it
        self._owner = threading.get_ident()

    def _check_owner(self, what: str) -> None:
        if threading.get_ident() != self._owner:
            raise RuntimeError(
                f"Telemetry.{what} called from a non-owner thread; the "
                "modeled clock and spans are serving-thread only — use "
                "count/count_time (integer-ns) from background threads")

    # -- modeled clock (serving thread only) ---------------------------
    def advance(self, dt: float) -> None:
        self._check_owner("advance")
        if dt > 0.0:
            self.clock_s += dt

    # -- instruments ---------------------------------------------------
    def count(self, name: str, v: int = 1, **labels: object) -> None:
        key = _label_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            c.inc(v)

    def count_time(self, name: str, seconds: float, **labels: object) -> None:
        """Accumulate a duration as integer ns (thread-order independent)."""
        self.count(name, _ns(seconds), **labels)

    def gauge(self, name: str, v: float, **labels: object) -> None:
        key = _label_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
            g.set(v)

    def observe(self, name: str, seconds: float, **labels: object) -> None:
        key = _label_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram()
            h.observe(seconds)

    # -- spans (serving thread only; timed on the modeled clock) -------
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def span(self, name: str, **tags: object) -> Iterator[None]:
        self._check_owner("span")
        label = name
        if tags:
            label += "[" + ",".join(f"{k}={tags[k]}" for k in sorted(tags)) + "]"
        stack = self._stack()
        stack.append(label)
        path = "/".join(stack)
        t0 = self.clock_s
        try:
            yield
        finally:
            dt = self.clock_s - t0
            stack.pop()
            with self._lock:
                rec = self._spans.get(path)
                if rec is None:
                    rec = self._spans[path] = [0, 0.0, 0.0]
                rec[0] += 1
                rec[1] += dt
                if dt > rec[2]:
                    rec[2] = dt

    # -- snapshot ------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Stable, JSON-serialisable snapshot (schema ``repro.telemetry/v1``)."""
        with self._lock:
            counters = {k: c.value for k, c in sorted(self._counters.items())}
            gauges = {k: g.value for k, g in sorted(self._gauges.items())}
            hists = {}
            for k, h in sorted(self._histograms.items()):
                hists[k] = {
                    "buckets_s": list(h.buckets),
                    "count": h.count,
                    "counts": list(h.counts),
                    "max_s": h.max if h.count else 0.0,
                    "min_s": h.min if h.count else 0.0,
                    "p50_s": h.quantile(0.50),
                    "p90_s": h.quantile(0.90),
                    "p99_s": h.quantile(0.99),
                    "sum_s": h.sum_ns / _NS,
                }
            spans = {
                k: {"count": int(rec[0]), "max_s": rec[2], "total_s": rec[1]}
                for k, rec in sorted(self._spans.items())
            }
        return {
            "schema": SCHEMA,
            "clock_s": self.clock_s,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "spans": spans,
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, separators=(",", ":"))


# -- module-global registry (mirrors dejavulib.faults) -----------------
_ACTIVE: Optional[Telemetry] = None


def install(t: Telemetry) -> Optional[Telemetry]:
    """Install *t* as the process-wide registry; returns the previous one.
    Re-binds the clock/span owner to the installing thread."""
    global _ACTIVE
    prev = _ACTIVE
    t._owner = threading.get_ident()
    _ACTIVE = t
    return prev


def uninstall(prev: Optional[Telemetry] = None) -> None:
    global _ACTIVE
    _ACTIVE = prev


def current() -> Optional[Telemetry]:
    return _ACTIVE


def active() -> bool:
    return _ACTIVE is not None


# -- cheap helpers: one `is None` check when telemetry is off ----------
def count(name: str, v: int = 1, **labels: object) -> None:
    t = _ACTIVE
    if t is not None:
        t.count(name, v, **labels)


def count_time(name: str, seconds: float, **labels: object) -> None:
    t = _ACTIVE
    if t is not None:
        t.count(name, _ns(seconds), **labels)


def observe(name: str, seconds: float, **labels: object) -> None:
    t = _ACTIVE
    if t is not None:
        t.observe(name, seconds, **labels)


def gauge(name: str, v: float, **labels: object) -> None:
    t = _ACTIVE
    if t is not None:
        t.gauge(name, v, **labels)


def advance(dt: float) -> None:
    t = _ACTIVE
    if t is not None:
        t.advance(dt)


def clock() -> float:
    t = _ACTIVE
    return t.clock_s if t is not None else 0.0


@contextmanager
def span(name: str, **tags: object) -> Iterator[None]:
    t = _ACTIVE
    if t is None:
        yield
    else:
        with t.span(name, **tags):
            yield
