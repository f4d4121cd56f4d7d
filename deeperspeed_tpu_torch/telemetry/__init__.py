"""Telemetry of the PyTorch port.  The registry is ported; the request
tracer (``trace.py``) and the serving event schema (``serving.py``) come
with the scheduler in a later slice."""

from .registry import (LATENCY_BUCKETS_S, CounterChannel,  # noqa: F401
                       HistogramChannel, JsonlSink, PrometheusTextfileSink,
                       ScalarChannel, TelemetryRegistry, get_registry,
                       registry_from_config, set_registry)
