"""Rotary position embedding, NeoX-style partial rotation (counterpart of
``deeperspeed_tpu/ops/transformer/rope.py``).

A pure elementwise pattern over the head dim: plain PyTorch, as the JAX
package left it to XLA.
"""

import torch


def rotary_tables(positions, rot_dim, base=10000, dtype=torch.float32):
    """cos/sin tables [..., seq, 1, rot_dim] for integer positions [..., seq],
    computed in fp32 and cast to ``dtype``."""
    inv_freq = 1.0 / (base ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                            device=positions.device) / rot_dim))
    freqs = positions.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return (torch.cos(emb)[..., None, :].to(dtype),
            torch.sin(emb)[..., None, :].to(dtype))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """Rotate the first ``rot_dim`` dims of each head of q and k."""
    rot_dim = cos.shape[-1]
    q_rot, q_pass = q[..., :rot_dim], q[..., rot_dim:]
    k_rot, k_pass = k[..., :rot_dim], k[..., rot_dim:]
    q_rot = q_rot * cos + _rotate_half(q_rot) * sin
    k_rot = k_rot * cos + _rotate_half(k_rot) * sin
    return torch.cat([q_rot, q_pass], -1), torch.cat([k_rot, k_pass], -1)
