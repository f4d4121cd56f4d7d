"""Memory-movement planning: when does every byte of parameter state move
(counterpart of ``deeperspeed_tpu/comm/memplan.py``; the names, the
arithmetic and the calibration file are the JAX package's).

The same cost model as ``comm/schedule.py`` (``telemetry/wire.py``'s
device tables), applied to parameter movement.  Pure host-side math:

* :func:`plan_chunk_stream` -- the offload planner: given each unit's byte
  size and an HBM budget, choose which units stay **resident** on the card
  (never streamed again) and how deep the issue-ahead **prefetch** of H2D
  copies runs for the rest.  The resident set grows greedily, largest unit
  first, until the modeled peak would pass the budget; the rest streams.
  Exposed transfer time is scored with ``stream_exposed_estimate`` at the
  card's host-link bandwidth.  ``runtime/zero/infinity.py`` runs the plan.
* :func:`plan_param_movement` -- the stage-3 movement plan.  The JAX
  function walks a traced step's jaxpr; the port has none, so its
  counterpart takes the gathers and releases of the stage-3 units in the
  order the first step made them (``runtime/zero/stage3.py``'s
  ``GatherLedger``: the forward, then the recompute in the backward) and
  gives each gather a :class:`MoveSite` from it to its release.  The
  gathers happen at the unit's call, so the lookahead is 0: the plan is
  analysis, as in the JAX package, and moves no gather.
* :func:`assert_hbm_fit` -- the static-placement guard: raises
  :class:`HBMBudgetError` when a static residency requirement exceeds the
  (possibly synthetic) HBM budget.

Calibration: a measured ``compute_s`` and host-link bandwidth persist in a
results directory (:func:`save_calibration`); :func:`load_calibration`
(a path or ``DST_TUNER_CACHE``) feeds them back into ``plan_schedule``'s
scoring and the chunk-stream planner in place of the analytic figures.
:func:`measure_h2d_bandwidth` times pinned host-to-card copies.

Wired behind ``comm.overlap.schedule.memory: "auto"|"static"|"off"``
(``runtime/engine.py``) and ``ZeroInfinityEngine(memory_schedule=...)``.
Every planned variant is bit-equal to the static placement: the plan moves
*when* bytes move, never what is computed.
"""

import dataclasses
import json
import math
import os
import time

from ..utils.logging import logger

#: default issue-ahead window (eqns) between a planned gather point and the
#: first consumer, in the JAX package's jaxpr plans; the port's eager plans
#: gather at the unit's call (lookahead 0)
DEFAULT_LOOKAHEAD = 8

#: calibration file name inside a results dir (the tuner cache)
CALIBRATION_FILE = "calibration.json"

#: env var naming the tuner-cache path (file or dir) engines load
#: calibration from
CALIBRATION_ENV = "DST_TUNER_CACHE"


class HBMBudgetError(RuntimeError):
    """A static memory placement does not fit the (synthetic) HBM budget."""


def assert_hbm_fit(what, required_bytes, budget_bytes):
    """Raise :class:`HBMBudgetError` when ``required_bytes`` exceeds the
    budget (no-op for a budget of None or 0: unbounded)."""
    if budget_bytes and required_bytes > budget_bytes:
        raise HBMBudgetError(
            f"{what}: static placement needs {required_bytes / 2**20:.1f} MiB resident "
            f"but the HBM budget is {budget_bytes / 2**20:.1f} MiB -- enable the memory "
            f"planner (comm.overlap.schedule.memory: auto) to stream it")


def device_kind_of(device=None):
    """The kind the device tables are keyed by: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, else ``"cpu"``.
    ``device`` None: the current card where there is one."""
    import torch

    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


# ------------------------------------------------------- gather/release plan

@dataclasses.dataclass
class MoveSite:
    """One planned parameter movement: gather before first use, release
    after last use."""

    name: str            # the gathered buffer's label
    nbytes: int          # gathered (device-resident) byte size
    first_use: int       # index of the earliest use
    last_use: int        # index of the last use
    gather_at: int       # planned gather issue point (first_use - lookahead)
    release_at: int      # planned release point (== last_use)

    @property
    def live_span(self):
        """Index span the gathered buffer stays resident."""
        return self.release_at - self.gather_at + 1


def plan_param_movement(events, lookahead=0):
    """First-use / last-use movement plan of the stage-3 gathers.

    ``events`` is the step's ordered list of ``(kind, name, nbytes)``,
    ``kind`` ``"gather"`` or ``"release"`` (``stage3.GatherLedger.events``);
    an event's index is its position in the list.  Each gather gets one
    :class:`MoveSite`: first use at the gather, last use at the event before
    its release (the buffer is gone at the release), gather point
    ``max(0, first_use - lookahead)``.  A gather never released (a step
    cut short) lasts to the last event."""
    open_at = {}
    sites = []
    for i, (kind, name, nbytes) in enumerate(events):
        if kind == "gather":
            open_at.setdefault(name, []).append((i, nbytes))
        elif open_at.get(name):
            first, nb = open_at[name].pop(0)
            sites.append((first, name, nb, i - 1))
    end = len(events) - 1
    sites += [(first, name, nb, end) for name, left in open_at.items()
              for first, nb in left]
    return [MoveSite(name=name, nbytes=nb, first_use=first, last_use=last,
                     gather_at=max(0, first - lookahead), release_at=last)
            for first, name, nb, last in sorted(sites)]


def movement_summary(sites):
    """Aggregate a :func:`plan_param_movement` result for logging/telemetry:
    total gathered bytes, the peak concurrently-live bytes under the
    planned gather/release points, and the mean live span."""
    if not sites:
        return {"n_sites": 0, "gathered_bytes": 0, "peak_live_bytes": 0,
                "mean_live_span": 0.0}
    events = []
    for s in sites:
        events.append((s.gather_at, s.nbytes))
        events.append((s.release_at + 1, -s.nbytes))
    live = peak = 0
    for _, delta in sorted(events, key=lambda e: (e[0], -e[1])):
        live += delta
        peak = max(peak, live)
    return {
        "n_sites": len(sites),
        "gathered_bytes": sum(s.nbytes for s in sites),
        "peak_live_bytes": peak,
        "mean_live_span": sum(s.live_span for s in sites) / len(sites),
    }


# ----------------------------------------------------------- chunk streaming

@dataclasses.dataclass
class MemoryPlan:
    """The planner's decision for one engine's parameter-movement schedule."""

    mode: str                   # "auto" (planned) | "static"
    resident: tuple             # unit names pinned on device across steps
    streamed: tuple             # unit names streamed per use
    prefetch_depth: int         # issue-ahead H2D transfers for streamed units
    resident_bytes: int         # bytes the resident set pins
    peak_bytes: int             # modeled peak device param residency
    hbm_budget_bytes: int       # the budget planned against (0 = unbounded)
    est_exposed_s: float        # modeled exposed (unhidden) transfer seconds
    est_static_exposed_s: float  # same model, static placement (depth 1,
    #                              nothing resident)
    reason: str                 # one-line human-readable rationale
    sites: tuple = ()           # optional MoveSites

    @property
    def tag(self):
        return (f"memplan[{len(self.resident)}r/"
                f"{len(self.streamed)}s d{self.prefetch_depth}]")

    def describe(self):
        return (f"{self.tag} resident {self.resident_bytes / 2**20:.2f} MiB, "
                f"peak {self.peak_bytes / 2**20:.2f} MiB"
                + (f" / budget {self.hbm_budget_bytes / 2**20:.2f} MiB"
                   if self.hbm_budget_bytes else "")
                + f", est exposed {self.est_exposed_s * 1e3:.3f} ms "
                f"(static {self.est_static_exposed_s * 1e3:.3f} ms) -- "
                f"{self.reason}")


def plan_chunk_stream(unit_bytes, *, hbm_budget_bytes=None,
                      compute_s_per_chunk=None, h2d_bytes_per_s=None,
                      working_bytes=0, passes=2, max_depth=4,
                      device_kind=None):
    """Plan the offload chunk stream: residency vs streaming vs prefetch.

    ``unit_bytes`` maps unit name -> device byte size (the ZeRO-Infinity
    chunks plus embed/head).  The model: a streamed unit crosses the host
    link ``passes`` times per step (fwd + bwd recompute); a resident unit
    never does but pins its bytes.  Peak residency is

        sum(resident) + (1 + depth) * max(streamed) + working_bytes

    (the unit in use plus ``depth`` issue-ahead transfers in flight).  The
    planner greedily pins the largest streamed unit while that peak fits
    the budget, then picks the smallest ``depth`` whose issue-ahead window
    hides a chunk transfer under the calibrated (or analytic) compute time.
    No budget (None/0) means plan overlap only: nothing resident, depth
    from the cost model.  ``device_kind`` None: the current card's
    (:func:`device_kind_of`).  Raises :class:`HBMBudgetError` when even one
    streamed chunk with no lookahead exceeds the budget."""
    from ..telemetry.wire import host_link_bandwidth, stream_exposed_estimate

    units = {str(k): int(v) for k, v in unit_bytes.items()}
    if not units:
        raise ValueError("plan_chunk_stream: no units to plan")
    if h2d_bytes_per_s is None:
        if device_kind is None:
            device_kind = device_kind_of()
        h2d_bytes_per_s = host_link_bandwidth(device_kind)
    budget = int(hbm_budget_bytes or 0)

    def depth_for(streamed_names):
        if not streamed_names:
            return 0
        if compute_s_per_chunk is None or compute_s_per_chunk <= 0:
            return 1
        worst = max(units[n] for n in streamed_names) / h2d_bytes_per_s
        return max(1, min(max_depth, math.ceil(worst / compute_s_per_chunk)))

    def peak(resident_names, streamed_names, depth):
        worst = max((units[n] for n in streamed_names), default=0)
        return (sum(units[n] for n in resident_names)
                + (1 + depth) * worst + working_bytes)

    # largest-first: both the transfer saving and the max(streamed) shrink
    by_size = sorted(units, key=lambda n: (-units[n], n))
    resident, streamed = [], list(by_size)
    if budget:
        while streamed:
            candidate = streamed[0]  # current largest streamed unit
            trial_res = resident + [candidate]
            trial_str = streamed[1:]
            d = depth_for(trial_str)
            if peak(trial_res, trial_str, d) <= budget:
                resident, streamed = trial_res, trial_str
            else:
                break
    depth = depth_for(streamed)
    # budget binds harder than the overlap-optimal depth: shed lookahead
    while budget and streamed and depth > 0 \
            and peak(resident, streamed, depth) > budget:
        depth -= 1
    pk = peak(resident, streamed, depth)
    if budget and pk > budget:
        raise HBMBudgetError(
            f"offload stream: even one {max(units.values()) / 2**20:.1f} MiB "
            f"chunk (+{working_bytes / 2**20:.1f} MiB working set) exceeds "
            f"the {budget / 2**20:.1f} MiB HBM budget; re-chunk the model")

    streamed_bytes = [units[n] for n in streamed] * max(passes, 1)
    exposed = stream_exposed_estimate(
        streamed_bytes, compute_s_per_chunk, h2d_bytes_per_s,
        depth=max(depth, 1))
    static_exposed = stream_exposed_estimate(
        [b for b in units.values()] * max(passes, 1),
        compute_s_per_chunk, h2d_bytes_per_s, depth=1)
    if not streamed:
        reason = "everything resident: HBM budget never binds"
    elif resident:
        reason = (f"resident set grew to {len(resident)} units before the "
                  f"budget bound; rest streams at depth {depth}")
    elif budget:
        reason = f"budget binds immediately; pure streaming at depth {depth}"
    else:
        reason = f"no budget given: overlap-only plan at depth {depth}"
    plan = MemoryPlan(
        mode="auto", resident=tuple(resident), streamed=tuple(streamed),
        prefetch_depth=depth, resident_bytes=sum(units[n] for n in resident),
        peak_bytes=pk, hbm_budget_bytes=budget, est_exposed_s=exposed,
        est_static_exposed_s=static_exposed, reason=reason)
    logger.info(f"comm.memplan: {plan.describe()}")
    return plan


def static_plan(unit_bytes, working_bytes=0):
    """The static placement expressed as a :class:`MemoryPlan` (everything
    streams, one disk read ahead, no issue-ahead H2D) -- the parity
    baseline and the ``describe()`` counterpart for benches."""
    units = {str(k): int(v) for k, v in unit_bytes.items()}
    worst = max(units.values(), default=0)
    return MemoryPlan(
        mode="static", resident=(), streamed=tuple(sorted(units)),
        prefetch_depth=0, resident_bytes=0,
        peak_bytes=2 * worst + working_bytes, hbm_budget_bytes=0,
        est_exposed_s=0.0, est_static_exposed_s=0.0,
        reason="static placement (parity baseline)")


# --------------------------------------------------------------- calibration

@dataclasses.dataclass
class Calibration:
    """One profile-once measurement, persisted in the tuner cache: the
    planner's compute and bandwidth terms, measured instead of analytic."""

    compute_s: float            # measured compute-only step seconds
    h2d_gbps: float = 0.0       # measured host->device GB/s (0 = unknown)
    device_kind: str = ""
    scale: float = 1.0          # measured/analytic step-time ratio
    step_time_s: float = 0.0    # the raw calibration step time
    timestamp: float = 0.0

    @property
    def h2d_bytes_per_s(self):
        return self.h2d_gbps * 1e9 if self.h2d_gbps > 0 else None


def save_calibration(results_dir, **fields):
    """Write the calibration record into the tuner cache (results dir);
    returns the file path."""
    os.makedirs(results_dir, exist_ok=True)
    cal = Calibration(timestamp=time.time(), **fields)
    path = os.path.join(results_dir, CALIBRATION_FILE)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cal), f, indent=2)
    return path


def load_calibration(path=None):
    """Load a persisted :class:`Calibration`, or None.

    ``path`` may be the json file or the results dir holding it; default
    is the ``DST_TUNER_CACHE`` env var (unset -> None: engines fall back
    to the analytic model, never to a stale implicit location)."""
    path = path or os.environ.get(CALIBRATION_ENV)
    if not path:
        return None
    if os.path.isdir(path):
        path = os.path.join(path, CALIBRATION_FILE)
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return None
    known = {f.name for f in dataclasses.fields(Calibration)}
    return Calibration(**{k: v for k, v in raw.items() if k in known})


def measure_h2d_bandwidth(nbytes=8 << 20, iters=3, device=None):
    """Measured host->device bandwidth (bytes/s): the mean time of ``iters``
    synchronized copies of an ``nbytes`` host buffer (pinned where the
    target is a card) to ``device`` (the current card unless the caller asks
    for the CPU), after one warm-up copy."""
    import torch

    if device is None:
        device = "cuda"
    device = torch.device(device)
    cuda = device.type == "cuda"
    buf = torch.ones(max(int(nbytes), 1 << 16), dtype=torch.uint8, pin_memory=cuda)
    dst = torch.empty(buf.shape, dtype=buf.dtype, device=device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    dst.copy_(buf, non_blocking=cuda)        # warm the path
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        dst.copy_(buf, non_blocking=cuda)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return buf.numel() / max(dt, 1e-9)


# ------------------------------------------------------------ process state

# active memory-schedule mode for tooling (last engine wins)
_ACTIVE_MEMORY_MODE = None


def set_active_memory_mode(mode):
    global _ACTIVE_MEMORY_MODE
    _ACTIVE_MEMORY_MODE = mode


def get_active_memory_mode():
    """The process's active ``comm.overlap.schedule.memory`` mode (None
    before any engine initialized)."""
    return _ACTIVE_MEMORY_MODE
