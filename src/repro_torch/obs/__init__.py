"""Zero-dependency tracing + metrics for the access/compute accounting.

Public surface: :class:`Tracer` (span recorder), :data:`NULL_TRACER`
(the disabled default every layer falls back to), :class:`TracePolicy`
(the ``ExperimentSpec.trace`` knob), :class:`Timeline` (the snapshot on
``RunResult.timeline``), the lane constants, and the metrics primitives.
"""
from .metrics import Counter, Gauge, Histogram, Metrics, NullMetrics
from .trace import (
    ACCESS,
    CHECKPOINT,
    COMPUTE,
    CONVERT,
    EPOCH,
    GATHER,
    H2D,
    LANES,
    NULL_TRACER,
    TraceEvent,
    TracePolicy,
    Tracer,
    Timeline,
)

__all__ = [
    "ACCESS",
    "CHECKPOINT",
    "COMPUTE",
    "CONVERT",
    "EPOCH",
    "GATHER",
    "H2D",
    "LANES",
    "NULL_TRACER",
    "Counter",
    "Gauge",
    "Histogram",
    "Metrics",
    "NullMetrics",
    "TraceEvent",
    "TracePolicy",
    "Tracer",
    "Timeline",
]
