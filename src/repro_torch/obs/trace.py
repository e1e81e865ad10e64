"""Span tracer: thread-safe, nestable, bounded, Chrome-trace exportable.

The paper's thesis is an accounting identity — epoch time = data access
time + H2D time + compute time — and until now the repo measured it with
scattered ``perf_counter`` pairs whose sums land in
:class:`~repro_torch.data.pipeline.AccessStats` with no way to see WHERE inside
an epoch the seconds went.  This module records the same intervals as
*spans* on a fixed set of lanes and exports a Chrome/Perfetto trace-event
JSON, so a human can open the timeline (``chrome://tracing`` or
https://ui.perfetto.dev) and watch the access pattern the sampling scheme
induces: random sampling's per-batch read spans dwarfing systematic's,
H2D staging overlapping compute, checkpoint serialization riding the
background thread while epochs keep running.

Design constraints, in order:

* **One measurement, two consumers.**  Where an interval feeds
  ``AccessStats`` the span IS the measurement (:meth:`Tracer.timespan`
  yields the duration and the caller books it into stats) — the trace and
  the stats can never silently diverge, which is the invariant
  ``RunResult.verify_timeline`` asserts.
* **Near-zero cost when disabled.**  :meth:`Tracer.span` returns a shared
  no-op context manager; :meth:`Tracer.event` is a guard-and-return;
  :meth:`Tracer.timespan` still times (its callers need the duration for
  stats either way — exactly what the code it replaced paid).
* **Bounded.**  Events land in a ring buffer (``deque(maxlen=...)``);
  overflow evicts the OLDEST events and counts them in ``dropped`` so a
  truncated timeline is visible, never silent.
* **Thread-per-lane export.**  Chrome trace ``tid`` is the lane, not the
  OS thread: access / h2d / compute / checkpoint / gather (+ the epoch
  structure lane), so the producer thread's reads, the stager's copies
  and the main thread's device calls render as parallel swimlanes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from .metrics import Metrics, NullMetrics

# ---- lanes (Chrome tid per lane, in display order) -------------------------
ACCESS = "access"          # storage reads (DataPipeline / SparsePipeline)
H2D = "h2d"                # host->device staging (DeviceStager, resident put)
COMPUTE = "compute"        # device calls (chunk scans, resident epochs)
CHECKPOINT = "checkpoint"  # snapshot / serialize / commit lifecycle
GATHER = "gather"          # sharded D2D reshard-to-replicated
EPOCH = "epoch"            # per-epoch structure markers
CONVERT = "convert"        # host-side batch formatting (e.g. CSR->ELL pad);
#                            NOT booked into AccessStats, so it gets its own
#                            lane — the accounting lanes above stay exactly
#                            the measurements stats books
LANES: Tuple[str, ...] = (EPOCH, ACCESS, CONVERT, H2D, GATHER, COMPUTE,
                          CHECKPOINT)

DEFAULT_BUFFER = 1 << 16


class TraceEvent:
    """One completed span: ``ts``/``dur`` are seconds relative to the
    tracer's epoch.  ``toplevel`` is False when the span was opened inside
    another span on the SAME lane (lane totals must not double-count
    nesting)."""

    __slots__ = ("name", "lane", "ts", "dur", "args", "parent", "toplevel")

    def __init__(self, name: str, lane: str, ts: float, dur: float,
                 args: Optional[Dict] = None, parent: Optional[str] = None,
                 toplevel: bool = True):
        self.name = name
        self.lane = lane
        self.ts = ts
        self.dur = dur
        self.args = args or {}
        self.parent = parent
        self.toplevel = toplevel

    def to_dict(self) -> Dict:
        d = {"name": self.name, "lane": self.lane, "ts": self.ts,
             "dur": self.dur, "toplevel": self.toplevel}
        if self.args:
            d["args"] = dict(self.args)
        if self.parent:
            d["parent"] = self.parent
        return d


class _NoopSpan:
    """Shared context manager for disabled tracing: no clock reads, no
    allocation per use.  ``dur`` stays 0.0 — callers that need the real
    duration use :meth:`Tracer.timespan` instead."""

    __slots__ = ()
    dur = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


_NOOP_SPAN = _NoopSpan()


class _Span:
    """Live span: times enter->exit and records on exit.  ``record=False``
    (the :meth:`Tracer.timespan` disabled path) still measures ``dur`` —
    the caller books it into AccessStats — but appends nothing."""

    __slots__ = ("tracer", "name", "lane", "args", "record", "t0", "dur")

    def __init__(self, tracer: "Tracer", name: str, lane: str,
                 args: Dict, record: bool):
        self.tracer = tracer
        self.name = name
        self.lane = lane
        self.args = args
        self.record = record
        self.t0 = 0.0
        self.dur = 0.0

    def set(self, **args) -> None:
        """Attach attributes discovered inside the span (byte counts,
        batch indices) — call before exit or they miss the event."""
        self.args.update(args)

    def __enter__(self):
        if self.record:
            self.tracer._push(self.name, self.lane)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur = time.perf_counter() - self.t0
        if self.record:
            parent, toplevel = self.tracer._pop(self.lane)
            self.tracer._append(self.name, self.lane, self.t0, self.dur,
                                self.args, parent, toplevel)
        return False


class Tracer:
    """Thread-safe span recorder over a bounded ring buffer.

    ``span(name, lane=..., **args)`` — trace-only interval; a shared no-op
    when disabled.  ``timespan(...)`` — interval whose duration the caller
    consumes (AccessStats booking): always timed, recorded only when
    enabled.  ``event(name, lane, t0, dur, **args)`` — an interval the
    caller already measured.  Spans nest; a span opened inside another
    span on the same lane is marked non-toplevel so
    :meth:`Timeline.lane_totals` never double-counts.

    Every recorded event also feeds a ``span_s.<lane>.<name>`` histogram
    on ``metrics`` (p50/p95/max per phase come for free).
    """

    def __init__(self, enabled: bool = True, buffer: int = DEFAULT_BUFFER,
                 metrics: Optional[Metrics] = None):
        self.enabled = enabled
        self.epoch = time.perf_counter()
        self.metrics = metrics if metrics is not None else (
            Metrics() if enabled else NullMetrics())
        self._events: deque = deque(maxlen=max(16, buffer))
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.dropped = 0

    # ---- span stack (per-thread; nesting + same-lane detection) ---------
    def _stack(self) -> List[Tuple[str, str]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, name: str, lane: str) -> None:
        self._stack().append((name, lane))

    def _pop(self, lane: str) -> Tuple[Optional[str], bool]:
        st = self._stack()
        st.pop()
        parent = st[-1][0] if st else None
        toplevel = not any(l == lane for _, l in st)
        return parent, toplevel

    def _append(self, name: str, lane: str, t0: float, dur: float,
                args: Optional[Dict], parent: Optional[str],
                toplevel: bool) -> None:
        ev = TraceEvent(name, lane, t0 - self.epoch, dur, args, parent,
                        toplevel)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)
        self.metrics.histogram(f"span_s.{lane}.{name}").observe(dur)

    # ---- recording entry points ----------------------------------------
    def span(self, name: str, lane: str = COMPUTE, **args):
        """Trace-only interval.  A shared allocation-free no-op when the
        tracer is disabled — safe on hot paths."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, lane, args, record=True)

    def timespan(self, name: str, lane: str = COMPUTE, **args):
        """Interval whose duration the CALLER also consumes (e.g. booked
        into :class:`~repro_torch.data.pipeline.AccessStats`).  Always measures
        ``dur`` — replacing a hand-rolled ``perf_counter`` pair at the
        same cost — and records the event only when enabled, so the span
        and the stats are the SAME measurement."""
        return _Span(self, name, lane, args, record=self.enabled)

    def event(self, name: str, lane: str = COMPUTE, t0: float = 0.0,
              dur: float = 0.0, **args) -> None:
        """Record an already-measured interval (``t0`` from
        ``time.perf_counter()``)."""
        if not self.enabled:
            return
        st = self._stack()
        parent = st[-1][0] if st else None
        toplevel = not any(l == lane for _, l in st)
        self._append(name, lane, t0, dur, args, parent, toplevel)

    # ---- extraction -----------------------------------------------------
    def timeline(self) -> "Timeline":
        """Snapshot the ring buffer + metrics into an immutable
        :class:`Timeline` (the ``RunResult.timeline`` payload)."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        return Timeline(events=events, metrics=self.metrics.snapshot(),
                        dropped=dropped)


#: process-wide disabled tracer — the default every instrumented layer
#: falls back to, so call sites never branch on "is tracing on".
NULL_TRACER = Tracer(enabled=False, buffer=16, metrics=NullMetrics())


@dataclasses.dataclass
class Timeline:
    """Immutable span record of one ``execute()`` call (the epochs THAT
    call ran — the same basis as ``RunResult.stats``), plus the metrics
    snapshot taken with it.  ``dropped`` counts ring-buffer evictions:
    a nonzero value means ``lane_totals`` undercounts and
    ``verify_timeline`` will refuse to reconcile."""
    events: List[TraceEvent]
    metrics: Dict = dataclasses.field(default_factory=dict)
    dropped: int = 0

    def lane_totals(self) -> Dict[str, float]:
        """Summed span seconds per lane, counting only TOPLEVEL spans of
        each lane (a child span on its parent's lane would double-book the
        interval)."""
        totals: Dict[str, float] = {}
        for ev in self.events:
            if ev.toplevel:
                totals[ev.lane] = totals.get(ev.lane, 0.0) + ev.dur
        return totals

    def to_chrome(self) -> Dict:
        """Chrome/Perfetto trace-event JSON object format: one metadata
        thread-name event per lane, then one complete ("X") event per
        span, timestamps in microseconds."""
        trace_events: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "repro_torch"}}]
        lanes = [l for l in LANES if any(e.lane == l for e in self.events)]
        lanes += sorted({e.lane for e in self.events} - set(lanes))
        tid = {lane: i for i, lane in enumerate(lanes)}
        for lane in lanes:
            trace_events.append({"name": "thread_name", "ph": "M", "pid": 0,
                                 "tid": tid[lane],
                                 "args": {"name": lane}})
            trace_events.append({"name": "thread_sort_index", "ph": "M",
                                 "pid": 0, "tid": tid[lane],
                                 "args": {"sort_index": tid[lane]}})
        for ev in self.events:
            args = {k: v for k, v in ev.args.items()}
            if ev.parent:
                args["parent"] = ev.parent
            trace_events.append({
                "name": ev.name, "ph": "X", "cat": ev.lane, "pid": 0,
                "tid": tid[ev.lane], "ts": ev.ts * 1e6,
                "dur": ev.dur * 1e6, "args": args})
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "metrics": self.metrics}}

    def save(self, path) -> Path:
        """Write :meth:`to_chrome` atomically (tmp + ``os.replace``) —
        open the result in ``chrome://tracing`` or ui.perfetto.dev."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.parent / f".tmp_{path.name}_{os.getpid()}"
        tmp.write_text(json.dumps(self.to_chrome()) + "\n")
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_chrome(path) -> Dict:
        """Parse + validate a saved Chrome trace (the CI artifact check).
        Returns the parsed dict; raises ``ValueError`` naming the first
        malformed event."""
        d = json.loads(Path(path).read_text())
        evs = d.get("traceEvents")
        if not isinstance(evs, list) or not evs:
            raise ValueError(f"{path}: no traceEvents array")
        for i, ev in enumerate(evs):
            for key in ("name", "ph", "pid", "tid"):
                if key not in ev:
                    raise ValueError(f"{path}: event {i} missing {key!r}")
            if ev["ph"] == "X":
                if not (isinstance(ev.get("ts"), (int, float))
                        and isinstance(ev.get("dur"), (int, float))
                        and ev["dur"] >= 0):
                    raise ValueError(
                        f"{path}: X event {i} ({ev['name']!r}) needs "
                        f"numeric ts and non-negative dur")
        return d

    def merged(self, later: "Timeline", gap: float = 1e-3) -> "Timeline":
        """Concatenate ``later`` after this timeline on one clock: the
        later events shift so their first span starts ``gap`` seconds
        after this timeline's last end (segment traces from resumed runs
        share no epoch, so wall-clock concatenation is the only honest
        composition)."""
        if not self.events:
            return later
        if not later.events:
            return self
        end = max(e.ts + e.dur for e in self.events)
        start = min(e.ts for e in later.events)
        shift = end + gap - start
        shifted = [TraceEvent(e.name, e.lane, e.ts + shift, e.dur,
                              dict(e.args), e.parent, e.toplevel)
                   for e in later.events]
        return Timeline(events=self.events + shifted,
                        metrics=later.metrics,
                        dropped=self.dropped + later.dropped)


@dataclasses.dataclass(frozen=True)
class TracePolicy:
    """How :func:`repro_torch.core.experiment.execute` traces a run.

    ``path`` (optional) receives the Chrome-trace JSON at the end of every
    ``execute`` call (atomic write; each segment of a resumed run rewrites
    it with that segment's timeline); ``buffer`` bounds the span ring
    buffer; ``enabled=False`` keeps the policy in the spec while tracing
    no-ops — the A/B knob for overhead studies.  Validated at plan time.
    """
    path: Optional[Path] = None
    buffer: int = DEFAULT_BUFFER
    enabled: bool = True

    def __post_init__(self):
        # normalize so a str-built policy compares equal to a Path-built
        # one (spec equality / hashability)
        if self.path is not None:
            object.__setattr__(self, "path", Path(self.path))

    def validate(self) -> None:
        if self.buffer < 16:
            raise ValueError(
                f"trace.buffer must hold >= 16 spans (got {self.buffer}) — "
                f"smaller rings drop the epoch structure immediately")
        if not isinstance(self.enabled, bool):
            raise ValueError(
                f"trace.enabled must be a bool (got {self.enabled!r})")

    def make_tracer(self) -> Tracer:
        return (Tracer(enabled=True, buffer=self.buffer)
                if self.enabled else NULL_TRACER)
