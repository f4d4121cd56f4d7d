"""Typed serving telemetry events (counterpart of
``deeperspeed_tpu/telemetry/serving.py``).

The scheduler, the speculation governor and the engine narrate their
decisions -- requeue, quarantine, failed round, queue wait, speculation
outcome -- through these helpers, so the channel names and tag schemas stay
in one place and the JSONL stream is machine-parsable.  Every helper is a
no-op on a disabled registry, like every other telemetry call site.

Channel map (all under ``infer/``):

* ``infer/requeue_count``        counter; tags: uid
* ``infer/requeue_cap_exceeded`` counter; tags: uid, count
* ``infer/quarantine_count``     counter; tags: uid, cause
* ``infer/step_failures``        counter; tags: cause, n_requests
* ``infer/queue_wait_s``         histogram (bucketed; enqueue -> first
                                 schedule); tags: slo
* ``infer/spec_drafted_tokens``  counter (drafts fed for verification)
* ``infer/spec_accepted_tokens`` counter (drafts that survived verification)
* ``infer/spec_accept_rate``     scalar (per-round accepted/drafted)
* ``infer/tokens_per_round``     scalar (tokens emitted per sequence-row)
* ``infer/spec_floor_breach``    counter; tags: rate, floor (the governor
                                 degraded speculation to k=0)
* ``trace/flight_dumps_rotated`` counter (oldest flight dumps deleted to
                                 admit new ones at the ``max_dumps`` cap;
                                 emitted by ``telemetry/trace.py``)

The latency channel uses the ``LATENCY_BUCKETS_S`` ladder so ``quantile()``
stays exact past the sample reservoir and the Prometheus export carries
cumulative ``le`` buckets.

The channels of the layers above the scheduler (front end, replica pool,
disaggregation, fabric, tenants, deployment) come with those layers.
"""

from .registry import LATENCY_BUCKETS_S, get_registry

REQUEUE = "infer/requeue_count"
REQUEUE_CAP_EXCEEDED = "infer/requeue_cap_exceeded"
QUARANTINE = "infer/quarantine_count"
STEP_FAILURES = "infer/step_failures"
QUEUE_WAIT = "infer/queue_wait_s"
SPEC_DRAFTED = "infer/spec_drafted_tokens"
SPEC_ACCEPTED = "infer/spec_accepted_tokens"
SPEC_ACCEPT_RATE = "infer/spec_accept_rate"
TOKENS_PER_ROUND = "infer/tokens_per_round"
SPEC_FLOOR_BREACH = "infer/spec_floor_breach"
FLIGHT_DUMPS_ROTATED = "trace/flight_dumps_rotated"


def emit_requeue(uid, count: int, cap=None) -> None:
    reg = get_registry()
    if not reg.enabled:
        return
    reg.counter(REQUEUE).inc(uid=str(uid))
    if cap is not None and count > cap:
        reg.counter(REQUEUE_CAP_EXCEEDED).inc(uid=str(uid), count=count)


def emit_quarantine(uid, cause: str) -> None:
    reg = get_registry()
    if reg.enabled:
        reg.counter(QUARANTINE).inc(uid=str(uid), cause=cause)


def emit_step_failure(cause: str, n_requests: int) -> None:
    reg = get_registry()
    if reg.enabled:
        reg.counter(STEP_FAILURES).inc(cause=cause, n_requests=n_requests)


def emit_queue_wait(slo: str, seconds: float) -> None:
    reg = get_registry()
    if reg.enabled:
        reg.histogram(QUEUE_WAIT, buckets=LATENCY_BUCKETS_S).observe(
            float(seconds), slo=slo or "standard")


def emit_speculation(drafted: int, accepted: int, emitted: int,
                     rows: int) -> None:
    """One scheduling round's speculation outcome: ``drafted`` tokens fed
    for verification, ``accepted`` survivors, ``emitted`` total new tokens
    across ``rows`` sequence-rows (the tokens/round multiplier)."""
    reg = get_registry()
    if not reg.enabled:
        return
    if drafted:
        reg.counter(SPEC_DRAFTED).inc(drafted)
        reg.counter(SPEC_ACCEPTED).inc(accepted)
        reg.scalar(SPEC_ACCEPT_RATE).record(accepted / drafted)
    if rows:
        reg.scalar(TOKENS_PER_ROUND).record(emitted / rows)


def emit_spec_floor(rate: float, floor: float) -> None:
    reg = get_registry()
    if reg.enabled:
        reg.counter(SPEC_FLOOR_BREACH).inc(rate=round(float(rate), 4),
                                           floor=round(float(floor), 4))
