"""Memory placement guards (counterpart of part of
``deeperspeed_tpu/comm/memplan.py``).

Only the static-placement guard is ported: :func:`assert_hbm_fit` raises
:class:`HBMBudgetError` when a static residency requirement exceeds a
(possibly synthetic) device-memory budget, which ``ZeroInfinityEngine``'s
``static`` schedule checks at construction.  The planners
(``plan_param_movement``, ``plan_chunk_stream``, the calibration) walk a
jaxpr and wait for ROADMAP Queue A, 'Offload'.
"""


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
