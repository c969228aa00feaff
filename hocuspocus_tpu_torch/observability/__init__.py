"""Observability the server core needs: span tracing with the update
lifecycle book, the metrics registry's primitives, the per-doc flight
recorder, the host cost ledger and wire telemetry.

A copy of the JAX package's modules of the same names. The Metrics
extension, the sampling profiler, the SLO engine, the fleet view and the
device watch are not ported yet (ROADMAP.md, Queue A).
"""

from .costs import CostLedger, get_cost_ledger
from .flight_recorder import FlightRecorder, get_flight_recorder
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import (
    Tracer,
    UpdateTraceBook,
    disable_tracing,
    enable_tracing,
    get_tracer,
)
from .wire import WireTelemetry, get_wire_telemetry

__all__ = [
    "CostLedger",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "UpdateTraceBook",
    "WireTelemetry",
    "disable_tracing",
    "enable_tracing",
    "get_cost_ledger",
    "get_flight_recorder",
    "get_tracer",
    "get_wire_telemetry",
]
