"""Typed telemetry channels with JSONL + Prometheus-textfile sinks.

The ``TelemetryRegistry`` is the structured replacement for the ad-hoc
``monitor`` event tuples: engines declare *channels* (scalar gauges,
monotonic counters, histograms) and every recorded sample becomes one JSONL
event on rank 0, plus an entry in the Prometheus textfile export.  A bounded
in-memory ring of recent events feeds the stall watchdog's diagnostic
snapshot.

Only process 0 writes files (``rank0_only``, the ``MonitorMaster``
convention); channels on other processes still accumulate in memory so
counter totals stay meaningful if the caller aggregates them itself.
"""

import json
import os
import threading
import time
from collections import deque

from ..utils.logging import logger


def _is_rank0():
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _prom_name(name):
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return "dst_" + s


def _prom_label_name(key):
    out = []
    for ch in str(key):
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out) or "_"
    if s[0].isdigit():
        s = "_" + s
    return s


def _prom_label_value(value):
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote and newline must be escaped inside ``"..."``."""
    s = str(value)
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(tags):
    """``{k="v",...}`` label block (sorted for stable output), or ``""``."""
    if not tags:
        return ""
    parts = [f'{_prom_label_name(k)}="{_prom_label_value(v)}"'
             for k, v in sorted(tags.items())]
    return "{" + ",".join(parts) + "}"


# Tag keys remembered per-channel for pool-level breakdowns (telemetry/
# aggregate.py merges these across hosts) and for the Prometheus label
# export.  High-cardinality keys (uid, step) are deliberately excluded.
BREAKDOWN_TAG_KEYS = ("tenant", "dtype", "slo", "variant", "kind", "peer")


class _Channel:
    kind = "scalar"

    def __init__(self, registry, name):
        self.registry = registry
        self.name = name
        # Last-seen values of the low-cardinality breakdown tags, rendered
        # as real Prometheus labels on export.  None until a tagged sample
        # arrives, so untagged channels keep the historical bare format.
        self.last_tags = None

    def _note_tags(self, tags):
        if not tags:
            return
        kept = {k: tags[k] for k in BREAKDOWN_TAG_KEYS if k in tags}
        if kept:
            self.last_tags = kept


class ScalarChannel(_Channel):
    """Last-value gauge (loss, MFU, step time...)."""

    kind = "scalar"

    def __init__(self, registry, name):
        super().__init__(registry, name)
        self.value = None

    def record(self, value, step=None, **tags):
        self.value = float(value)
        self._note_tags(tags)
        self.registry._emit(self.name, self.value, step=step, kind=self.kind,
                            tags=tags)


class CounterChannel(_Channel):
    """Monotonic counter (tokens served, bytes on wire, stalls...)."""

    kind = "counter"

    def __init__(self, registry, name):
        super().__init__(registry, name)
        self.total = 0.0
        # Per-tag-value subtotals for the breakdown keys, e.g.
        # ``{"tenant": {"gold": 12.0}}`` -- summed across hosts by the
        # pool aggregator for per-tenant / per-dtype views.
        self.by_tag = {}

    def inc(self, n=1.0, step=None, **tags):
        v = float(n)
        self.total += v
        self._note_tags(tags)
        for key in BREAKDOWN_TAG_KEYS:
            if key in tags:
                sub = self.by_tag.setdefault(key, {})
                val = str(tags[key])
                sub[val] = sub.get(val, 0.0) + v
        self.registry._emit(self.name, self.total, step=step, kind=self.kind,
                            tags=tags)


# Shared latency bucket ladder (seconds): 1ms..10s, roughly log-spaced.
# The ``infer/*`` latency channels all use it so their Prometheus exports
# and quantile estimates are comparable across regimes.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0)


class HistogramChannel(_Channel):
    """Streaming summary (count/sum/min/max) + bounded sample reservoir,
    with optional explicit bucket boundaries (Prometheus-style cumulative
    ``le`` buckets).  While the reservoir still holds every observation the
    ``quantile`` accessor interpolates exactly; once it overflows, bucketed
    channels fall back to bucket interpolation over *all* observations
    instead of a biased recent-window estimate."""

    kind = "histogram"

    def __init__(self, registry, name, max_samples=512, buckets=None):
        super().__init__(registry, name)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._samples = deque(maxlen=max_samples)
        self.buckets = tuple(sorted(float(b) for b in buckets)) \
            if buckets else None
        # bucket_counts[i] counts observations <= buckets[i] (cumulative,
        # the Prometheus convention); the implicit +Inf bucket is ``count``
        self.bucket_counts = [0] * len(self.buckets) if self.buckets else None
        # Per-tag-value ``[count, sum]`` for the breakdown keys.
        self.by_tag = {}

    def observe(self, value, step=None, **tags):
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._samples.append(v)
        self._note_tags(tags)
        for key in BREAKDOWN_TAG_KEYS:
            if key in tags:
                sub = self.by_tag.setdefault(key, {})
                cs = sub.setdefault(str(tags[key]), [0, 0.0])
                cs[0] += 1
                cs[1] += v
        if self.buckets is not None:
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self.bucket_counts[i] += 1
        self.registry._emit(self.name, v, step=step, kind=self.kind, tags=tags)

    def quantile(self, q):
        """Interpolated quantile, ``q`` in [0, 1].  Exact (linear between
        order statistics) while the reservoir is complete; bucket-edge
        interpolation once it has dropped old samples."""
        if not self.count:
            return None
        q = min(max(float(q), 0.0), 1.0)
        if self.buckets is not None and self.count > len(self._samples):
            rank = q * self.count
            prev_le, prev_cum = None, 0
            for le, cum in zip(self.buckets, self.bucket_counts):
                if cum >= rank:
                    lo = min(self.min if prev_le is None else prev_le, le)
                    frac = ((rank - prev_cum) / (cum - prev_cum)
                            if cum > prev_cum else 1.0)
                    return lo + frac * (le - lo)
                prev_le, prev_cum = le, cum
            return self.max  # rank beyond the last finite bucket
        s = sorted(self._samples)
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def percentile(self, q):
        """Legacy accessor, ``q`` in [0, 100]."""
        return self.quantile(q / 100.0)

    def summary(self):
        mean = self.sum / self.count if self.count else 0.0
        return {"count": self.count, "sum": self.sum, "mean": mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class JsonlSink:
    """One JSON object per line, append-only; cheap enough for per-step use."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1 << 16)

    def write(self, event):
        if self._f.closed:   # stale sink (engine destroyed) must not
            return           # throw into the path that emitted the event
        self._f.write(json.dumps(event) + "\n")

    def flush(self):
        if not self._f.closed:
            self._f.flush()

    def close(self):
        try:
            self._f.flush()
            self._f.close()
        except Exception:
            pass


class PrometheusTextfileSink:
    """node_exporter textfile-collector format, rewritten atomically on each
    flush: gauges export last value, counters their running total, histograms
    a count/sum summary pair.

    Channels that carried breakdown tags (``dtype=``, ``tenant=``...) export
    them as real Prometheus labels with proper label-value escaping --
    ``dst_infer_kv_bytes{dtype="fp8"} 4096`` -- while untagged channels keep
    the historical bare ``name value`` form."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def export(self, channels):
        lines = []
        for ch in channels:
            pname = _prom_name(ch.name)
            labels = _prom_labels(getattr(ch, "last_tags", None))
            if ch.kind == "scalar":
                if ch.value is None:
                    continue
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname}{labels} {ch.value}")
            elif ch.kind == "counter":
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname}_total {ch.total}")
                for key, sub in sorted(getattr(ch, "by_tag", {}).items()):
                    for val, total in sorted(sub.items()):
                        lab = _prom_labels({key: val})
                        lines.append(f"{pname}_total{lab} {total}")
            elif ch.kind == "histogram":
                if not ch.count:
                    continue
                if getattr(ch, "buckets", None):
                    lines.append(f"# TYPE {pname} histogram")
                    for le, cum in zip(ch.buckets, ch.bucket_counts):
                        lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                    lines.append(f'{pname}_bucket{{le="+Inf"}} {ch.count}')
                else:
                    lines.append(f"# TYPE {pname} summary")
                lines.append(f"{pname}_count {ch.count}")
                lines.append(f"{pname}_sum {ch.sum}")
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        os.replace(tmp, self.path)


class TelemetryRegistry:
    """Channel registry + sink fan-out.

    ``enabled=False`` builds a null registry: channels exist and accumulate
    nothing, ``_emit`` is a no-op -- call sites never branch.
    """

    def __init__(self, enabled=True, run_dir="telemetry", job_name="run",
                 jsonl=True, prometheus=False, rank0_only=True,
                 buffer_events=256, flush_every=32):
        self.enabled = enabled
        self.run_dir = os.path.join(run_dir or "telemetry", job_name or "run")
        self._channels = {}
        self._recent = deque(maxlen=max(buffer_events, 1))
        self._flush_every = max(flush_every, 1)
        self._since_flush = 0
        self._lock = threading.Lock()
        self._writes = enabled and ((not rank0_only) or _is_rank0())
        self.jsonl_path = None
        self.prometheus_path = None
        self._jsonl = None
        self._prom = None
        if self._writes and jsonl:
            self.jsonl_path = os.path.join(self.run_dir, "events.jsonl")
            self._jsonl = JsonlSink(self.jsonl_path)
        if self._writes and prometheus:
            self.prometheus_path = os.path.join(self.run_dir, "metrics.prom")
            self._prom = PrometheusTextfileSink(self.prometheus_path)

    # ----------------------------------------------------------- channels
    def _channel(self, name, cls, **kwargs):
        ch = self._channels.get(name)
        if ch is None:
            ch = cls(self, name, **kwargs)
            self._channels[name] = ch
        elif not isinstance(ch, cls):
            raise TypeError(
                f"telemetry channel {name!r} already registered as "
                f"{type(ch).__name__}, not {cls.__name__}")
        return ch

    def scalar(self, name):
        return self._channel(name, ScalarChannel)

    def counter(self, name):
        return self._channel(name, CounterChannel)

    def histogram(self, name, buckets=None):
        """``buckets`` (sorted upper bounds) only takes effect on the call
        that first creates the channel; later lookups return it as-is."""
        if name in self._channels:
            return self._channel(name, HistogramChannel)
        return self._channel(name, HistogramChannel, buckets=buckets)

    def emit(self, name, value, step=None, kind="scalar", **tags):
        """One-shot convenience: record into the named channel."""
        if kind == "counter":
            self.counter(name).inc(value, step=step, **tags)
        elif kind == "histogram":
            self.histogram(name).observe(value, step=step, **tags)
        else:
            self.scalar(name).record(value, step=step, **tags)

    # -------------------------------------------------------------- sinks
    def _emit(self, name, value, step=None, kind="scalar", tags=None):
        if not self.enabled:
            return
        event = {"ts": time.time(), "name": name, "value": value,
                 "kind": kind}
        if step is not None:
            event["step"] = int(step)
        if tags:
            event.update(tags)
        with self._lock:
            self._recent.append(event)
            if self._jsonl is not None:
                self._jsonl.write(event)
            self._since_flush += 1
            if self._since_flush >= self._flush_every:
                self._flush_locked()

    def _flush_locked(self):
        self._since_flush = 0
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._prom is not None:
            try:
                self._prom.export(list(self._channels.values()))
            except Exception as e:  # telemetry must never kill the step
                logger.warning(f"prometheus export failed: {e}")

    def flush(self):
        with self._lock:
            self._flush_locked()

    def recent(self, n=None):
        """Last ``n`` events (all buffered events when ``n`` is None)."""
        with self._lock:
            events = list(self._recent)
        return events if n is None else events[-n:]

    def channel_items(self):
        """Stable ``(name, channel)`` list for snapshot/export consumers
        (``telemetry/aggregate.py``).  Only the dict copy is taken under the
        lock; readers tolerate concurrently-updated channel fields."""
        with self._lock:
            return list(self._channels.items())

    def close(self):
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()


_GLOBAL = TelemetryRegistry(enabled=False)


def get_registry():
    """Process-global registry (a disabled null registry until configured)."""
    return _GLOBAL


def set_registry(registry):
    global _GLOBAL
    _GLOBAL = registry
    return registry


def registry_from_config(cfg, job_name=None):
    """Build a registry from a ``TelemetryConfig`` block and install it as
    the process-global default (so inference / standalone components find
    it via :func:`get_registry`)."""
    reg = TelemetryRegistry(
        enabled=cfg.enabled,
        run_dir=cfg.output_path or "telemetry",
        job_name=job_name or cfg.job_name or "run",
        jsonl=cfg.jsonl,
        prometheus=cfg.prometheus,
        rank0_only=cfg.rank0_only,
        buffer_events=cfg.buffer_events,
        flush_every=cfg.flush_every,
    )
    if cfg.enabled:
        set_registry(reg)
    trace_cfg = getattr(cfg, "trace", None)
    if trace_cfg is not None and getattr(trace_cfg, "enabled", False):
        from .trace import tracer_from_config  # avoid import cycle

        tracer_from_config(cfg, job_name=job_name)
    return reg
