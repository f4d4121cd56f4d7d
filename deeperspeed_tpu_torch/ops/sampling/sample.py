"""Token sampling and speculative-draft acceptance (counterpart of
``deeperspeed_tpu/ops/sampling/sample.py``).

Runs on the device beside the model, so logits never round-trip to the
host.  Noise comes from an explicit ``torch.Generator``; it cannot give
JAX's bits, so the sampled path is held to its properties (the top-k filter
confines samples, top-k 1 is greedy), and greedy decoding is bit-exact.

``verify_draft`` is the longest-accepted-prefix rule of speculative
decoding: draft i is accepted iff drafts 1..i-1 were and the model's choice
at the previous position equals draft i.
"""

import torch

from ..cuda_utils import NEG_INF
from .topk import sorted_topk


def sample_tokens(logits, generator=None, *, temperature=0.0, top_k=0,
                  top_p=1.0):
    """Pick one token per (row, position) from ``logits`` [n, R, V].

    temperature <= 0 is greedy argmax (lowest index on ties).  Otherwise:
    temperature scaling, the top-k filter (threshold from the sorted top-k
    kernel), nucleus top-p, then Gumbel-argmax with noise drawn from
    ``generator`` (on the logits' device).  -> [n, R] int32.
    """
    n, R, V = logits.shape
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.to(torch.float32).reshape(n * R, V) / float(temperature)
    if 0 < top_k < V:
        kth = sorted_topk(x, int(top_k))[0][:, -1]
        x = torch.where(x >= kth[:, None], x, NEG_INF)
    if top_p < 1.0:
        svals = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(svals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < float(top_p)          # first token always kept
        cnt = keep.sum(dim=-1).clamp(min=1)
        pth = torch.gather(svals, 1, (cnt - 1)[:, None])
        x = torch.where(x >= pth, x, NEG_INF)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(x + g, dim=-1).reshape(n, R).to(torch.int32)


def verify_draft(chosen, draft_tokens, draft_lens):
    """Longest-accepted-prefix over right-aligned drafts.

    chosen       [n, R]   tokens the model chose at the R scored positions
    draft_tokens [n, R-1] drafts, right-aligned: row i's d_1..d_dk sit in
                          columns R-1-dk .. R-2 (left pad is ignored)
    draft_lens   [n]      dk per row (0 = non-speculative row)
    -> accepted [n] int32 in [0, draft_lens].
    """
    n, R = chosen.shape
    if R == 1:
        return torch.zeros(n, dtype=torch.int32, device=chosen.device)
    draft_lens = draft_lens.to(torch.int32)
    offs = (R - 1) - draft_lens                                  # [n]
    idx = torch.arange(R - 1, dtype=torch.int32, device=chosen.device)[None]
    eq = (chosen[:, :R - 1] == draft_tokens) | (idx < offs[:, None])
    run = torch.cumprod(eq.to(torch.int32), dim=1).sum(dim=1)
    lo = torch.zeros_like(draft_lens)
    return torch.minimum(torch.maximum(run - offs, lo),
                         draft_lens).to(torch.int32)
