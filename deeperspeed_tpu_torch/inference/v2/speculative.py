"""Speculative-decoding drafters + the accept-rate governor (counterpart of
``deeperspeed_tpu/inference/v2/speculative.py``).

Drafting is the only host-side piece of the speculative pipeline, and it
is deliberately model-free by default: ``NGramDrafter`` is prompt-lookup
self-speculation (Saxena's "prompt lookup decoding", the n-gram drafter of
vLLM/TGI) -- find the most recent earlier occurrence of the sequence's own
trailing n-gram and propose the tokens that followed it.  Greedy decode
loops repeat themselves (code, JSON, extractive answers, and the shared-
prefix serving workload all do), so the lookup is cheap and surprisingly
accurate, and there is no second model to place, load, or schedule.

``CallableDrafter`` is the ``method: "draft"`` seam: any callable
``(token_history, k) -> draft tokens`` -- typically a small model's own
greedy decode -- plugs into the same verify/accept machinery; the engine
does not care where drafts come from.

``SpeculationGovernor`` watches the realized accept rate.  Speculation
costs (k+1)-wide rows; when drafts stop landing (adversarial text, an
injected rejection storm) it degrades to k=0 plain decoding with a rank-0
warning + ``infer/spec_floor_breach`` event, then re-probes after a
cooldown so a transient storm doesn't permanently disable the multiplier.
"""

import logging
from typing import Callable, List, Optional, Sequence

from ...utils.logging import log_dist
from ...telemetry import serving as serving_events
from .config import SpeculativeConfig


class NGramDrafter:
    """Prompt-lookup drafts: match the trailing n-gram, copy what followed.

    Longest n (``ngram_max`` down to ``ngram_min``) wins; among equal-n
    matches the MOST RECENT earlier occurrence wins (recent context is the
    best predictor of the continuation).  Returns at most ``k`` tokens,
    possibly fewer near the end of the match's continuation, or [] when
    nothing matches (the round then decodes that row non-speculatively).
    """

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(f"bad n-gram window [{ngram_min}, {ngram_max}]")
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        L = len(history)
        if k <= 0 or L < self.ngram_min + 1:
            return []
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            tail = tuple(history[L - n:])
            # scan right-to-left over earlier occurrences (most recent wins);
            # stop before the trailing occurrence itself
            for start in range(L - n - 1, -1, -1):
                if tuple(history[start:start + n]) == tail:
                    cont = history[start + n:start + n + k]
                    if cont:
                        return [int(t) for t in cont]
        return []


class CallableDrafter:
    """Adapter for ``method: "draft"``: defer to an external draft fn.

    ``draft_fn(history, k)`` returns up to k proposed token ids -- e.g. a
    distilled model's greedy rollout.  Exceptions and over-long drafts are
    contained here so a buggy drafter degrades to non-speculative decoding
    instead of poisoning the round.
    """

    def __init__(self, draft_fn: Callable[[Sequence[int], int], Sequence[int]]):
        self.draft_fn = draft_fn

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        if k <= 0:
            return []
        try:
            out = self.draft_fn(history, k)
        except Exception:
            return []
        return [int(t) for t in list(out)[:k]]


def make_drafter(cfg: SpeculativeConfig,
                 draft_fn: Optional[Callable] = None):
    if not cfg.enabled:
        return None
    if cfg.method == "ngram":
        return NGramDrafter(cfg.ngram_max, cfg.ngram_min)
    if draft_fn is None:
        raise ValueError('speculative.method == "draft" needs a draft_fn '
                         '(see CallableDrafter)')
    return CallableDrafter(draft_fn)


class SpeculationGovernor:
    """Degrade speculation to k=0 when the accept rate stops paying.

    EMA of per-round accept rate; ``floor_patience`` consecutive
    speculative rounds below ``accept_rate_floor`` disables drafting
    (effective k = 0) for ``floor_cooldown`` rounds, after which the EMA
    resets and speculation re-probes.  Rounds that drafted nothing (no
    n-gram hit) don't move the EMA -- they cost nothing either.
    """

    def __init__(self, cfg: SpeculativeConfig):
        self.cfg = cfg
        self.ema: Optional[float] = None
        self._below = 0
        self._cooldown_left = 0
        self.breaches = 0

    @property
    def active(self) -> bool:
        return self._cooldown_left == 0

    @property
    def effective_k(self) -> int:
        if not self.cfg.enabled or not self.active:
            return 0
        return self.cfg.k

    def observe(self, drafted: int, accepted: int) -> None:
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            if self._cooldown_left == 0:
                # re-probe with a clean slate
                self.ema = None
                self._below = 0
                log_dist("speculation re-enabled after cooldown, probing",
                         ranks=[0])
            return
        if drafted <= 0:
            return
        rate = accepted / drafted
        a = self.cfg.accept_rate_alpha
        self.ema = rate if self.ema is None else a * rate + (1 - a) * self.ema
        if self.ema < self.cfg.accept_rate_floor:
            self._below += 1
            if self._below >= self.cfg.floor_patience:
                self._cooldown_left = max(1, self.cfg.floor_cooldown)
                self.breaches += 1
                log_dist(
                    f"speculative accept rate {self.ema:.3f} below floor "
                    f"{self.cfg.accept_rate_floor:.3f} for {self._below} "
                    f"rounds: degrading to non-speculative decoding for "
                    f"{self._cooldown_left} rounds", ranks=[0],
                    level=logging.WARNING)
                serving_events.emit_spec_floor(self.ema,
                                               self.cfg.accept_rate_floor)
        else:
            self._below = 0
