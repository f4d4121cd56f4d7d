"""Cost-model collective scheduling: plan the gradient reduction's schedule,
and issue each reduction at its earliest legal point (counterpart of
``deeperspeed_tpu/comm/schedule.py``; the plan's names and arithmetic are
the JAX package's).

* :func:`plan_schedule` -- choose the reduction's schedule (deferred or
  per-microbatch issue, bucket size, qgZ) by scoring the candidates with
  ``telemetry/wire.py``'s cost model (``plain_wire_bytes``,
  ``ici_bandwidth`` over the backend the reduction runs on,
  ``overlap_estimate``).
* The JAX package then traces the step, hoists every collective to its
  earliest dataflow-legal point in the jaxpr (``hoist_collectives``) and
  jits the rewritten program (``ScheduledStepFn``).  The port's step is
  eager, so its counterpart issues the reductions from gradient hooks: the
  engine (``runtime/engine.py`` ``_install_hooks``) issues a bucket's
  collective, asynchronously, from the backward as soon as the last
  gradient it covers is final.  :class:`ScheduledStep` holds that pass's
  statistics as ``ScheduledStepFn`` does: ``n_collectives``, ``n_hoisted``
  and ``sites``, the :class:`CollectiveSite` of every collective the first
  planned step issued, recorded through the comm facade
  (:func:`record_sites`).
* The port has no GSPMD, hence no implicit (``sharding_constraint``)
  collective sites: ``SchedulePlan.implicit_sites`` stays 0.

Wired behind ``comm.overlap.schedule: {"mode": "auto"|"manual"|"off"}``
(``runtime/engine.py``): ``manual`` keeps the hand-placed deferred path, the
parity baseline; ``auto`` plans, and the hook-issued reduction computes the
same bits as the ``manual`` run with the plan's bucket size.
"""

import contextlib
import dataclasses
import math

from ..utils.logging import logger
from .overlap import bucketize  # noqa: F401  (re-exported for planners)

# the facade's collectives -> wire-model collective kind
COLLECTIVE_KINDS = {
    "all_reduce": "all_reduce",
    "all_reduce_quantized": "all_reduce",
    "reduce_scatter": "reduce_scatter",
    "reduce_scatter_quantized": "reduce_scatter",
    "all_gather": "all_gather",
    "all_gather_into": "all_gather",
    "all_to_all": "all_to_all",
    "all_to_all_v": "all_to_all",
    "broadcast": "broadcast",
}


# ---------------------------------------------------------------- discovery

@dataclasses.dataclass
class CollectiveSite:
    """One collective the step issued.  The JAX fields, read for an eager
    step: ``path`` is where it was issued from (``("hook",)``: a gradient
    hook in the backward; ``("step",)``: the step's own code), ``index`` the
    position of its first call in the step, ``primitive`` the facade
    function, ``repeats`` its calls a step with this payload."""

    path: tuple          # ("hook",) or ("step",)
    index: int           # position of the first such call in the step
    primitive: str       # the facade function
    kind: str            # wire-model kind ("all_reduce", ...)
    dtype: str           # payload dtype name (int8/float8_* tag the quantized wire)
    n_elems: int         # payload element count
    repeats: int         # calls a step
    axes: tuple          # the mesh axes the group spans
    gspmd_kind: str = ""  # implicit sites only: none here

    @property
    def quantized(self):
        return (self.dtype in ("int8", "uint8")
                or self.dtype.startswith("float8_")
                or self.primitive.endswith("_quantized"))


class SiteRecorder:
    """Collects the facade's collectives while it is installed
    (:func:`record_sites`): ``where`` names the issuer of the calls made
    from now on (``"hook"`` or ``"step"``)."""

    def __init__(self):
        self.where = "step"
        self._sites = {}

    def __call__(self, primitive, tensor, axes):
        dtype = str(tensor.dtype).replace("torch.", "")
        key = ((self.where,), primitive, dtype, tensor.numel(), tuple(axes))
        site = self._sites.get(key)
        if site is None:
            self._sites[key] = CollectiveSite(
                path=(self.where,), index=len(self._sites), primitive=primitive,
                kind=COLLECTIVE_KINDS.get(primitive, primitive), dtype=dtype,
                n_elems=tensor.numel(), repeats=1, axes=tuple(axes))
        else:
            site.repeats += 1

    @contextlib.contextmanager
    def issuing(self, where):
        """The calls of the block come from ``where``."""
        saved, self.where = self.where, where
        try:
            yield
        finally:
            self.where = saved

    @property
    def sites(self):
        return tuple(self._sites.values())


@contextlib.contextmanager
def record_sites(recorder):
    """Install ``recorder`` on the comm facade for the block: each outermost
    collective call is handed to it."""
    from . import comm

    saved, comm._site_recorder = comm._site_recorder, recorder
    try:
        yield recorder
    finally:
        comm._site_recorder = saved


class ScheduledStep:
    """The eager counterpart of the JAX package's ``ScheduledStepFn``: the
    statistics of the planned step, published by the engine after its first
    planned step.  ``n_collectives`` counts that step's collective calls,
    ``n_hoisted`` those issued from a gradient hook (before the backward
    ended), ``sites`` are their :class:`CollectiveSite`\\ s, ``move_sites``
    the stage-3 movement plan (``comm/memplan.py``)."""

    def __init__(self, label="step"):
        self.label = label
        self.n_collectives = 0
        self.n_hoisted = 0
        self.sites = ()
        self.move_sites = ()
        self.published = False

    def publish(self, sites):
        self.published = True
        self.sites = tuple(sites)
        self.n_collectives = sum(s.repeats for s in self.sites)
        self.n_hoisted = sum(s.repeats for s in self.sites if s.path == ("hook",))
        logger.info(f"comm.schedule[{self.label}]: {self.n_collectives} collective calls "
                    f"(0 implicit GSPMD sites), {self.n_hoisted} issued from gradient "
                    f"hooks at their earliest point")


# ------------------------------------------------------------------ planner

@dataclasses.dataclass
class SchedulePlan:
    """The pass's decision for one engine's grad-reduce + issue schedule."""

    mode: str                  # "auto" (planned) -- manual/off never plan
    grad_schedule: str         # "deferred" | "per_microbatch"
    bucket_mb: float           # chosen bucket size (deferred only)
    hoist: bool                # issue each reduction at its earliest point
    qgz: bool                  # quantized (qgZ/1-bit) reduce owns the wire
    fallback: bool             # False: every regime here is *planned*
    reason: str                # one-line human-readable rationale
    wire_bytes: float          # predicted per-step grad-reduce wire bytes
    est_exposed_s: float       # predicted exposed (unhidden) comm seconds
    candidates: tuple = ()     # (name, est_exposed_s, wire_bytes) per option
    # implicit (GSPMD sharding_constraint) sites: none in the port
    implicit_sites: int = 0
    implicit_wire_bytes: float = 0.0

    @property
    def tag(self):
        """Telemetry label for the chosen schedule."""
        base = self.grad_schedule
        if self.qgz:
            base = "quantized"
        if self.grad_schedule == "deferred" and self.bucket_mb > 0:
            base += f"[b{self.bucket_mb:g}mb]"
        return base + ("+hoist" if self.hoist else "")

    def describe(self):
        out = (f"{self.tag} (wire {self.wire_bytes / 2**20:.2f} MiB/step, "
               f"est exposed {self.est_exposed_s * 1e3:.3f} ms) -- "
               f"{self.reason}")
        if self.implicit_sites:
            out += (f"; {self.implicit_sites} gspmd site"
                    f"{'s' if self.implicit_sites != 1 else ''} "
                    f"(~{self.implicit_wire_bytes / 2**20:.2f} MiB/step)")
        return out


# per-issue dispatch latency: penalizes pathological bucket counts in the
# scorer; coarse by design (the score only ranks candidates under one
# topology)
_ISSUE_LATENCY_S = 5e-6


def _bucket_count(grad_bytes, bucket_mb):
    if bucket_mb <= 0:
        return 1
    return max(1, math.ceil(grad_bytes / (bucket_mb * 2**20)))


def plan_schedule(*, grad_bytes, gas, n_ranks, deferred_allowed,
                  blockers=(), bucket_mb=0.0, qgz=False,
                  device_kind=None, compute_s=None, backend="nccl"):
    """Score grad-reduce schedule candidates with the telemetry cost model
    and return the winning :class:`SchedulePlan`.

    ``grad_bytes`` is the full gradient payload in wire dtype; ``n_ranks``
    the reduction group size.  ``deferred_allowed`` is False for regimes
    the deferred path does not serve (the ``blockers``) -- those get a
    *planned* per-microbatch issue, not a fallback.  ``compute_s``, when
    known (one profiled step), bounds how much comm each candidate can hide
    via ``overlap_estimate``; without it the scorer uses the
    bucket-pipelining exposure model alone.  ``device_kind`` None: the
    current card's; ``backend``: the process group's (``nccl`` or
    ``gloo``), which picks the interconnect figure."""
    from ..telemetry.wire import ici_bandwidth, overlap_estimate, plain_wire_bytes

    if device_kind is None:
        from .memplan import device_kind_of

        device_kind = device_kind_of()
    bw = ici_bandwidth(device_kind, backend)

    def exposed(wire, n_issues):
        """Predicted unhidden comm time: every issue but the last can
        overlap the compute still in flight behind it, so exposure shrinks
        with issue count; a known compute budget caps the hideable part."""
        est = wire / bw
        exp = est / max(n_issues, 1) + _ISSUE_LATENCY_S * n_issues
        if compute_s is not None:
            # comm the profiled compute cannot absorb is exposed no matter
            # how the issues pipeline: step time is bounded below by
            # max(compute, comm), so the floor is est - compute_s
            exp = max(exp, overlap_estimate(wire, max(compute_s, est),
                                            compute_s, bw)["exposed_s"])
        return exp

    if qgz:
        # the quantized (qgZ / 1-bit) engines already issue one fused
        # once-per-batch reduction
        wire = plain_wire_bytes("all_reduce", grad_bytes / 4, n_ranks)
        return SchedulePlan(
            mode="auto", grad_schedule="deferred", bucket_mb=bucket_mb,
            hoist=True, qgz=True, fallback=False,
            reason="quantized reduce already deferred; issued once a batch",
            wire_bytes=wire, est_exposed_s=exposed(wire, 1))

    candidates = []
    # per-microbatch: one reduction per microbatch -- gas issues, gas x the
    # wire bytes, each overlappable with the next microbatch's backward
    # except the last
    per_mb_wire = plain_wire_bytes("all_reduce", grad_bytes, n_ranks) * gas
    candidates.append(("per_microbatch", exposed(per_mb_wire, gas),
                       per_mb_wire))
    if deferred_allowed:
        one_issue_wire = plain_wire_bytes("all_reduce", grad_bytes, n_ranks)
        options = {0.0, 4.0, 16.0}
        if bucket_mb > 0:
            options.add(float(bucket_mb))
        for bmb in sorted(options):
            k = _bucket_count(grad_bytes, bmb)
            candidates.append((f"deferred[bucket_mb={bmb:g}]",
                               exposed(one_issue_wire, k), one_issue_wire))

    # least exposed comm wins; wire bytes break ties, then deferred beats
    # per-microbatch (at gas=1 the two are identical -- planning deferred
    # keeps auto on the manual path's exact schedule)
    best = min(candidates, key=lambda c: (
        c[1], c[2], 0 if c[0].startswith("deferred") else 1))
    name, est_exp, wire = best
    if name.startswith("deferred"):
        chosen_bmb = float(name.split("=", 1)[1].rstrip("]"))
        return SchedulePlan(
            mode="auto", grad_schedule="deferred", bucket_mb=chosen_bmb,
            hoist=True, qgz=False, fallback=False,
            reason=f"deferred issue cuts wire bytes {gas}x vs per-microbatch",
            wire_bytes=wire, est_exposed_s=est_exp,
            candidates=tuple(candidates))
    reason = ("per-microbatch issue, hook-issued"
              + (f" (deferred blocked: {'; '.join(blockers)})"
                 if blockers else ""))
    return SchedulePlan(
        mode="auto", grad_schedule="per_microbatch", bucket_mb=0.0,
        hoist=True, qgz=False, fallback=False, reason=reason,
        wire_bytes=wire, est_exposed_s=est_exp, candidates=tuple(candidates))


# ------------------------------------------------------------ process state

# active schedule mode for tooling (last engine init wins)
_ACTIVE_MODE = None


def set_active_mode(mode):
    global _ACTIVE_MODE
    _ACTIVE_MODE = mode


def get_active_mode():
    """The process's active ``comm.overlap.schedule.mode`` (None before any
    engine initialized)."""
    return _ACTIVE_MODE
