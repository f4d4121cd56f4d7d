"""Collective-op logging with algorithmic-bandwidth accounting
(counterpart of ``deeperspeed_tpu/comm/comms_logging.py``, itself after
upstream's ``deepspeed/utils/comms_logging.py:34``): per-op latency,
message size and alg/bus bandwidth, and the summary table that
``comm.log_summary()`` prints.

The JAX package's collectives are traced once and run every step, so it
records each step's *analytic* wire bytes at trace time
(``record_traced`` between ``begin_trace_capture`` and
``end_trace_capture``).  The port runs eagerly: the engine opens a record
around each step's gradient reduction (:meth:`CommsLogger.begin_step`),
the reduction's parts add their analytic bytes (:meth:`CommsLogger.record`)
and :meth:`CommsLogger.end_step` returns the step's footprint with the
JAX record's keys ``(op, variant, n_ranks, schedule, bytes, count)``.
"""

import sys
from collections import defaultdict

from ..utils.logging import logger


def get_caller_func(frame=3):
    """Name of the first function outside the ``deeperspeed_tpu_torch.comm``
    package on the call stack (walking out, so that a decorator's frames do
    not count); ``frame`` is the fallback depth when the walk finds
    nothing."""
    pkg = __name__.rsplit(".", 1)[0]  # "deeperspeed_tpu_torch.comm"
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod != "functools" and mod != pkg and not mod.startswith(pkg + "."):
            return f.f_code.co_name
        f = f.f_back
    try:
        return sys._getframe(frame).f_code.co_name
    except ValueError:
        return "<unknown>"


def calc_bw_log(name, size_bytes, duration, n):
    """Algorithmic + bus bandwidth in GB/s for a collective over n ranks."""
    duration = max(duration, 1e-9)
    alg_bw = size_bytes / duration
    if "all_to_all" in name:
        bus_bw = alg_bw * ((n - 1) / n)
    elif "all_gather" in name or "reduce_scatter" in name:
        size_bytes = size_bytes * n
        alg_bw = size_bytes / duration
        bus_bw = alg_bw * ((n - 1) / n)
    elif "all_reduce" in name:
        bus_bw = alg_bw * (2 * (n - 1) / n)
    else:  # broadcast / p2p
        bus_bw = alg_bw
    return size_bytes, alg_bw / 1e9, bus_bw / 1e9


class CommsLogger:
    def __init__(self):
        self.comms_dict = defaultdict(lambda: defaultdict(lambda: [0, [], [], []]))
        # the group sizes each logged op ran over (hpZ's gathers: zshard's)
        self.group_sizes = defaultdict(set)
        self.verbose = False
        self.debug = False
        self.prof_ops = []
        self.prof_all = True
        self.enabled = False
        self._capturing = False
        self._step_records = []

    def configure(self, enabled=True, verbose=False, prof_all=True, prof_ops=None,
                  debug=False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.debug = debug

    def start_profiling_comms(self):
        self.prof_all = True

    def stop_profiling_comms(self):
        self.prof_all = False

    # ------------------------------------------------ per-step footprints
    def begin_step(self):
        self._capturing = True
        self._step_records = []

    def end_step(self):
        """Stop recording; returns the step's footprint: one record per
        (op, variant, n_ranks, schedule) with its total bytes and count."""
        self._capturing = False
        agg = {}
        for rec in self._step_records:
            key = (rec["op"], rec["variant"], rec["n_ranks"], rec["schedule"])
            slot = agg.setdefault(key, {"op": rec["op"], "variant": rec["variant"],
                                        "n_ranks": rec["n_ranks"],
                                        "schedule": rec["schedule"],
                                        "bytes": 0.0, "count": 0})
            slot["bytes"] += rec["bytes"]
            slot["count"] += rec["count"]
        self._step_records = []
        return list(agg.values())

    def record(self, op, wire_bytes, n_ranks, variant="fp32", count=1, schedule=None):
        """Add one collective's analytic per-device wire bytes to the open
        step (no-op outside one).  ``schedule`` names the issue schedule,
        ``per_microbatch`` or ``deferred``."""
        if not self._capturing:
            return
        self._step_records.append({
            "op": op, "variant": variant, "bytes": float(wire_bytes),
            "n_ranks": int(n_ranks), "count": int(count), "schedule": schedule,
        })

    # ------------------------------------------------------- timed ops
    def append(self, raw_name, record_name, latency, msg_size, n_ranks):
        if self.prof_ops and raw_name not in self.prof_ops and not self.prof_all:
            return
        msg_size, alg_bw, bus_bw = calc_bw_log(raw_name, msg_size, latency, max(n_ranks, 1))
        self.group_sizes[record_name].add(int(n_ranks))
        entry = self.comms_dict[record_name][msg_size]
        entry[0] += 1
        entry[1].append(latency * 1000.0)
        entry[2].append(alg_bw)
        entry[3].append(bus_bw)
        if self.verbose:
            logger.info(
                f"comm op: {record_name} | time (ms): {latency * 1000.0:.2f} | "
                f"msg size: {msg_size} | algbw (Gbps): {alg_bw * 8:.2f} | "
                f"busbw (Gbps): {bus_bw * 8:.2f}")

    def log_all(self, print_log=True, show_straggler=False):
        """Summary rows ``(op, msg size, count, avg ms, algbw GB/s, busbw
        GB/s)``; ``show_straggler`` appends the min and max latency and
        their spread per (op, size) row -- the spread across calls of one
        collective, timed on this process's host clock."""
        rows = []
        for record_name, data in self.comms_dict.items():
            for msg_size, (count, lats, albws, busbws) in sorted(data.items()):
                avg_lat = sum(lats) / len(lats) if lats else 0.0
                avg_alg = sum(albws) / len(albws) if albws else 0.0
                avg_bus = sum(busbws) / len(busbws) if busbws else 0.0
                row = (record_name, msg_size, count, avg_lat, avg_alg, avg_bus)
                if show_straggler:
                    lo = min(lats) if lats else 0.0
                    hi = max(lats) if lats else 0.0
                    row = row + (lo, hi, hi - lo)
                rows.append(row)
        if print_log and rows:
            hdr = (f"{'Comm Op':<20}{'Msg Size':<12}{'Count':<8}"
                   f"{'Avg Lat(ms)':<14}{'algbw GB/s':<12}{'busbw GB/s':<12}")
            if show_straggler:
                hdr += f"{'Min(ms)':<10}{'Max(ms)':<10}{'Straggler(ms)':<14}"
            logger.info(hdr)
            for r in rows:
                line = (f"{r[0]:<20}{r[1]:<12}{r[2]:<8}{r[3]:<14.3f}"
                        f"{r[4]:<12.3f}{r[5]:<12.3f}")
                if show_straggler:
                    line += f"{r[6]:<10.3f}{r[7]:<10.3f}{r[8]:<14.3f}"
                logger.info(line)
        return rows
