"""Analytic bytes-on-wire model for collectives, ring convention, and the
card's link figures the planners price against (counterpart of
``deeperspeed_tpu/telemetry/wire.py``; the names and the arithmetic are the
JAX package's).

Pure math, shared by the engine's per-step footprint of its gradient
reduction (``runtime/engine.py`` ``_record_grad_reduce_wire``), the qgZ
wrappers (``runtime/zero/quantized.py``), the facade's quantized
collectives (``comm/comm.py``) and the planners (``comm/schedule.py``
``plan_schedule``, ``comm/memplan.py`` ``plan_chunk_stream``).  Conventions:

* ring all_reduce of ``B`` payload bytes over ``n`` ranks moves
  ``2 * B * (n - 1) / n`` per device (reduce-scatter + all-gather phases);
* ring reduce_scatter / all_to_all move ``B * (n - 1) / n``;
* ring all_gather of a ``B``-byte *shard* moves ``B * (n - 1)``;
* broadcast / ppermute move ``B`` (each device forwards the payload once);
* a block-scaled payload of ``N`` elements (int8 or fp8 -- both one byte)
  costs ``N + 4 * ceil(N / group_size)`` bytes (1B data + fp32 scales).

The device tables hold the card's figures, never a TPU's: the host link
(pinned host memory to the card) and the interconnect a collective runs
over, by backend -- gloo, which stages CUDA tensors through host memory
(the only backend two processes on one card can run), and NCCL.  A device
kind found in no table prices at the CPU nominals, the JAX package's
(5e9 host link, 10e9 interconnect), so that both packages plan alike
there.
"""

import math


def q_bytes(n_elems, group_size):
    """Wire bytes of a 1-byte block-scaled payload: 1B/elem + fp32 scales."""
    return n_elems + 4 * math.ceil(n_elems / max(group_size, 1))


def variant_dtype(variant):
    """The dtype label a variant string carries: ``fp32`` / ``int8`` /
    ``fp8``."""
    return variant.split("_", 1)[0] if variant else "fp32"


def wire_bytes(collective, variant, n_elems, n1, n2, group_size):
    """Analytic per-device bytes on the wire for the quantized schedules.

    ``collective`` is ``all_reduce`` or ``reduce_scatter``; ``variant`` is
    ``fp32`` or ``<dtype>_flat`` / ``<dtype>_two_level`` with ``<dtype>``
    in ``int8`` / ``fp8``.  ``n1`` = intra-group size, ``n2`` = inter-group
    size (``n2 == 1`` -> flat).  fp32 all_reduce is ring RS + ring AG:
    ``2 * 4N * (n-1)/n``."""
    n = n1 * n2
    fp32 = 4 * n_elems
    if variant == "fp32":
        full = fp32 * (n - 1) / n
        return 2 * full if collective == "all_reduce" else full
    if variant.endswith("_flat"):
        rs = q_bytes(n_elems, group_size) * (n - 1) / n
        if collective == "reduce_scatter":
            return rs
        ag = q_bytes(n_elems // n, group_size) * (n - 1)
        return rs + ag
    # <dtype>_two_level: intra hop full payload, inter hop 1/n1 of it
    rs = (q_bytes(n_elems, group_size) * (n1 - 1) / n1
          + q_bytes(n_elems // n1, group_size) * (n2 - 1) / n2)
    if collective == "reduce_scatter":
        return rs
    ag = (q_bytes(n_elems // (n1 * n2), group_size) * (n2 - 1)
          + q_bytes(n_elems // n1, group_size) * (n1 - 1))
    return rs + ag


def plain_wire_bytes(collective, payload_bytes, n):
    """Per-device wire bytes of an unquantized collective over ``n`` ranks.

    ``payload_bytes`` is the byte size of the tensor the caller handed the
    collective (the full tensor for all_reduce / reduce_scatter /
    all_to_all / broadcast / ppermute; the local shard for all_gather)."""
    if n <= 1:
        return 0.0
    if collective == "all_reduce":
        return 2.0 * payload_bytes * (n - 1) / n
    if collective in ("reduce_scatter", "all_to_all"):
        return payload_bytes * (n - 1) / n
    if collective == "all_gather":
        return float(payload_bytes) * (n - 1)
    # broadcast / ppermute / p2p: the payload crosses the wire once
    return float(payload_bytes)


def quantized_variant(n1, n2, wire_dtype="int8"):
    """Variant label for the qgZ schedule given the (intra, inter) split
    and the wire dtype (``int8`` default; any fp8 spelling -> ``fp8``)."""
    name = str(wire_dtype).lower()
    label = "fp8" if ("fp8" in name or "e4m3" in name or "e5m2" in name) \
        else "int8"
    return f"{label}_two_level" if n2 > 1 else f"{label}_flat"


# Host -> device bandwidth (bytes/s, one direction, from pinned host
# memory) by device-kind substring: what ``comm/memplan.py`` prices the
# chunk stream's H2D against.
HOST_LINK_BANDWIDTH_SPECS = {
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit: chip_smoke.py phase
    # 25 (a), measure_h2d_bandwidth over 256 MiB of pinned memory, read
    # 45.13 and 46.19 GB/s in two runs; the slower is kept.  Phase 24 (a)'s
    # 3.035 GB copies of pinned bf16 parameters ran at 44.68-54.93 GB/s.
    # Phase 25 (a) holds this figure within 2x of its reading on every run.
    "NVIDIA H100 80GB HBM3": 45.13e9,
}

# CPU hosts: host<->"device" is a memcpy; nominal figure keeps estimates
# finite and planned-vs-static comparisons meaningful in tests.
_CPU_HOST_LINK_BANDWIDTH = 5e9


def host_link_bandwidth(device_kind):
    """Host<->device bandwidth in bytes/s for ``device_kind`` (longest
    substring match, same convention as :func:`ici_bandwidth`)."""
    hit = match_device_spec(HOST_LINK_BANDWIDTH_SPECS, device_kind)
    return hit[1] if hit else _CPU_HOST_LINK_BANDWIDTH


def stream_exposed_estimate(chunk_bytes_list, compute_s_per_chunk,
                            bw_bytes_per_s, depth=1):
    """Analytic exposed (unhidden) seconds of a chunked host->device stream.

    Each chunk's transfer can hide under up to ``depth`` chunks' worth of
    compute issued ahead of its use (the issue-ahead window); whatever
    doesn't fit is exposed.  ``compute_s_per_chunk`` None means no compute
    estimate -- conservatively everything is exposed (the same convention
    as :func:`overlap_estimate`)."""
    bw = max(bw_bytes_per_s, 1.0)
    exposed = 0.0
    for b in chunk_bytes_list:
        t = b / bw
        if compute_s_per_chunk is None:
            exposed += t
        else:
            exposed += max(0.0, t - compute_s_per_chunk * max(depth, 1))
    return exposed


# Per-device interconnect bandwidth (bytes/s, one direction, in ring wire
# bytes) by backend and device-kind substring: what ``comm/schedule.py``
# scores the gradient reduction's schedules against.
ICI_BANDWIDTH_SPECS = {
    "nccl": {
        # NVIDIA H100 80GB HBM3 (SXM5, 700.00 W): the data sheet's NVLink
        # figure, 900 GB/s both directions together, halved.  The data
        # sheet's, not measured: the one-card machine runs no NCCL.
        "NVIDIA H100 80GB HBM3": 450e9,
    },
    "gloo": {
        # NVIDIA H100 80GB HBM3 at 700.00 W, two processes on the card:
        # chip_smoke.py phase 14's stage-2 step reduce-scattered 649.3 MB of
        # fp32 gradients (324.6 MB of ring wire bytes) in 1,451.89 ms on the
        # host clock, staging copies included.
        "NVIDIA H100 80GB HBM3": 2.236e8,
    },
}

# CPU hosts (tests, smoke runs): nominal loopback-ish figure so the
# estimate stays finite; absolute values are not meaningful.
_CPU_ICI_BANDWIDTH = 10e9


def match_device_spec(specs, device_kind):
    """The spec entry whose key is the LONGEST substring of ``device_kind``
    (case-insensitive), or ``None``: ``(key, value)``.  Longest match, not
    first match, so that a generation key never prices a variant whose name
    it prefixes."""
    kind = (device_kind or "").lower()
    best = None
    for key, val in specs.items():
        if key.lower() in kind and (best is None or len(key) > len(best[0])):
            best = (key, val)
    return best


def ici_bandwidth(device_kind, backend="nccl"):
    """Per-device interconnect bandwidth (bytes/s) for ``device_kind`` over
    ``backend`` (``nccl`` or ``gloo``; longest substring match)."""
    hit = match_device_spec(ICI_BANDWIDTH_SPECS.get(backend, {}), device_kind)
    return hit[1] if hit else _CPU_ICI_BANDWIDTH


def overlap_estimate(comm_bytes, step_time_s, compute_s, bw_bytes_per_s):
    """Analytic exposed-vs-overlapped split of one step's comm time.

    ``comm_bytes`` is the step's per-device bytes-on-wire total;
    ``compute_s`` the compute-only time estimate (None when unknown).  The
    comm time the step could NOT hide behind compute is bounded below by
    ``step_time - compute_s``; everything else counts as overlapped:

        est_comm_s = comm_bytes / bw
        exposed_s  = clamp(step_time - compute_s, 0, est_comm_s)
        overlapped = est_comm_s - exposed_s

    Without a compute estimate the split is unknowable -- conservatively
    report everything exposed.  Returns ``{"est_comm_s", "exposed_s",
    "overlapped_s", "overlap_frac"}``."""
    est_comm_s = comm_bytes / max(bw_bytes_per_s, 1.0)
    if compute_s is None:
        exposed = est_comm_s
    else:
        exposed = min(max(step_time_s - compute_s, 0.0), est_comm_s)
    overlapped = est_comm_s - exposed
    return {
        "est_comm_s": est_comm_s,
        "exposed_s": exposed,
        "overlapped_s": overlapped,
        "overlap_frac": overlapped / est_comm_s if est_comm_s > 0 else 0.0,
    }
