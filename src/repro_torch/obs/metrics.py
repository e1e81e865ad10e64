"""Counters / gauges / histograms registry for the tracing subsystem.

The paper's accounting identity (training time = access time + compute
time) needs more than totals to act on: WHERE the access seconds
concentrate is a distribution question (one slow wrap-around read vs a
uniformly slow storage path look identical in a sum).  This module keeps
that distribution observable with three primitive families, all
zero-dependency and thread-safe:

* :class:`Counter` — monotonically increasing totals (batches staged,
  line-search invocations, checkpoint saves).
* :class:`Gauge` — last-written values (mesh width, chunk shape).
* :class:`Histogram` — per-phase duration distributions over a bounded
  reservoir, snapshot as count/sum/max/p50/p95 — the per-phase measured
  timings the ROADMAP's cost-model planner consumes as ground truth.

A :class:`Metrics` registry owns one namespace of each and snapshots to a
plain JSON-safe dict (the ``metrics`` block of ``RunResult.to_json``).
The tracer feeds one histogram per span lane+name automatically; callers
add counters/gauges explicitly where a quantity is not a duration.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

# histogram reservoir depth: enough for every per-batch phase of a
# CI-scale run while bounding memory on million-batch sweeps (percentiles
# are then over the most recent window, which is what a drifting machine
# makes you want anyway)
DEFAULT_WINDOW = 4096


class Counter:
    """Monotonic total.  ``inc`` is the only mutator."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Bounded-reservoir distribution: exact count/sum/max over the whole
    stream, percentiles over the most recent ``window`` observations."""

    __slots__ = ("count", "total", "max", "_window", "_lock")

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._window: deque = deque(maxlen=max(1, window))
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v > self.max:
                self.max = v
            self._window.append(v)

    def percentile(self, q: float) -> float:
        """q in [0, 1] over the retained window (0.0 when empty)."""
        with self._lock:
            data = sorted(self._window)
        if not data:
            return 0.0
        idx = min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))
        return data[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            data = sorted(self._window)
            count, total, mx = self.count, self.total, self.max
        def pct(q):
            if not data:
                return 0.0
            return data[min(len(data) - 1,
                            max(0, int(round(q * (len(data) - 1)))))]
        return {"count": count, "sum": total, "max": mx,
                "p50": pct(0.5), "p95": pct(0.95)}


class Metrics:
    """Thread-safe registry of named counters/gauges/histograms.

    Names are free-form dotted strings (``"access.read"``,
    ``"ls.invocations"``); the first access under a name creates the
    instrument, later accesses return the same one — instruments never
    need pre-registration, so instrumentation sites stay one-liners.
    """

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._window = window
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(self._window)
            return h

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-safe view: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, max, p50, p95}}}.  Safe to call
        while other threads keep observing (each instrument locks
        itself)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(hists.items())},
        }


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for the disabled tracer — every
    mutator is a constant-time early return, so instrumentation sites never
    branch on enablement themselves."""

    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics(Metrics):
    """Registry whose instruments all discard writes (disabled tracing)."""

    def __init__(self):
        super().__init__(window=1)

    def counter(self, name: str):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def gauge(self, name: str):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def histogram(self, name: str):  # type: ignore[override]
        return _NULL_INSTRUMENT

    def snapshot(self) -> Dict[str, Dict]:
        return {"counters": {}, "gauges": {}, "histograms": {}}
