"""Observability: span tracing, metrics registry, Prometheus endpoint,
per-doc flight recorder, the update-lifecycle trace pipeline, the
sampling CPU profiler, SLO burn rates, the fleet view and the device
watch.

A copy of the JAX package's modules of the same names, with the same
metric names and labels. The device watch classifies the merge plane's
kernel launches (`CompileTracker`, the plane's `WarmWatch`) where the
JAX package classifies XLA compiles, and `/debug/profile` captures with
`torch.profiler` where the JAX package uses `jax.profiler`.
"""

from .costs import CostLedger, get_cost_ledger
from .device_watch import CompileTracker
from .extension import Metrics
from .profiler import SamplingProfiler, get_profiler
from .fleet import (
    ClockOffsetEstimator,
    FleetView,
    build_digest,
    get_fleet_view,
    stamp_header,
)
from .flight_recorder import FlightRecorder, get_flight_recorder
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .slo import SloEngine, SloTarget, counter_ratio_slo, fraction_slo, latency_slo
from .tracing import (
    Tracer,
    UpdateTraceBook,
    disable_tracing,
    enable_tracing,
    get_tracer,
)
from .wire import WireTelemetry, get_wire_telemetry

__all__ = [
    "ClockOffsetEstimator",
    "CompileTracker",
    "CostLedger",
    "Counter",
    "FleetView",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Metrics",
    "MetricsRegistry",
    "SamplingProfiler",
    "SloEngine",
    "SloTarget",
    "Tracer",
    "UpdateTraceBook",
    "WireTelemetry",
    "build_digest",
    "counter_ratio_slo",
    "disable_tracing",
    "enable_tracing",
    "fraction_slo",
    "get_cost_ledger",
    "get_fleet_view",
    "get_flight_recorder",
    "get_profiler",
    "get_tracer",
    "get_wire_telemetry",
    "latency_slo",
    "stamp_header",
]
