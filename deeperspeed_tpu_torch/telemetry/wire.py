"""Analytic bytes-on-wire model for collectives, ring convention
(counterpart of ``deeperspeed_tpu/telemetry/wire.py``; the names and the
arithmetic are the JAX package's).

Pure math, shared by the engine's per-step footprint of its gradient
reduction (``runtime/engine.py`` ``_record_grad_reduce_wire``), the qgZ
wrappers (``runtime/zero/quantized.py``) and the facade's quantized
collectives (``comm/comm.py``).  Conventions:

* ring all_reduce of ``B`` payload bytes over ``n`` ranks moves
  ``2 * B * (n - 1) / n`` per device (reduce-scatter + all-gather phases);
* ring reduce_scatter / all_to_all move ``B * (n - 1) / n``;
* ring all_gather of a ``B``-byte *shard* moves ``B * (n - 1)``;
* broadcast / ppermute move ``B`` (each device forwards the payload once);
* a block-scaled payload of ``N`` elements (int8 or fp8 -- both one byte)
  costs ``N + 4 * ceil(N / group_size)`` bytes (1B data + fp32 scales).

The JAX module's device tables (host-link and ICI bandwidth by TPU
generation, ``overlap_estimate``, ``stream_exposed_estimate``,
``match_device_spec``) are not ported yet (ROADMAP Queue A, 'The rest of
the surface').
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
