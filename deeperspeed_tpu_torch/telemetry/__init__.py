"""Telemetry of the PyTorch port: the channel registry, the request tracer
(``trace.py``) and the serving event schema (``serving.py``)."""

from .registry import (LATENCY_BUCKETS_S, CounterChannel,  # noqa: F401
                       HistogramChannel, JsonlSink, PrometheusTextfileSink,
                       ScalarChannel, TelemetryRegistry, get_registry,
                       registry_from_config, set_registry)
from .trace import (FLIGHT_REASONS, FlightRecorder, Span,  # noqa: F401
                    TraceContext, Tracer, get_tracer, quantile, set_tracer,
                    slo_percentiles, tenant_percentiles, tracer_from_config)
