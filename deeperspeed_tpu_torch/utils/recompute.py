"""Recompute with an explicit generator: ``torch.utils.checkpoint`` that
replays the draws of a ``torch.Generator`` (the engine's), not only the
default ones."""

from torch.utils.checkpoint import checkpoint


def checkpoint_replaying(fn, *args, rng=None):
    """``fn(*args)`` whose activations are recomputed in the backward pass
    (non-reentrant ``torch.utils.checkpoint``).  The checkpoint replays the
    default generators, not ``rng``: the recompute sets ``rng`` back to its
    state at entry, so it draws the forward's values again (dropout masks),
    and then restores the state it found, so later draws are those a run
    without recompute makes."""
    entry = None if rng is None else rng.get_state()
    runs = [0]

    def run(*a):
        runs[0] += 1
        if rng is None or runs[0] == 1:
            return fn(*a)
        later = rng.get_state()
        rng.set_state(entry)
        try:
            return fn(*a)
        finally:
            rng.set_state(later)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
