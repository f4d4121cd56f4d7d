"""TiledLinear: a large linear as a grid of weight tiles (counterpart of
``deeperspeed_tpu/runtime/zero/tiling.py``, reference
``runtime/zero/tiling.py:32``).

``y[:, out_j] = sum_i x[:, in_i] @ W_ij + b_j``: the numerics of one
``Linear`` whose weight is the block matrix of the tiles.  Each tile
``kernel_{i}_{j}`` and bias ``bias_{j}`` is its own parameter, stored as
the JAX package's leaf is, ``[in/in_splits, out/out_splits]``.  Under ZeRO
stage 3 each tile is a unit of its own (a child module the engine gathers
at its call), so only one tile's weight is gathered at a time; with
``remat_each_tile`` each tile's product runs under
``torch.utils.checkpoint``, so the backward gathers each tile again
rather than keeping every gathered tile alive.
"""

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


class _Tile(nn.Module):
    """One tile's weight ``kernel`` [d_in, d_out]: its own module, so that
    stage 3 gathers it alone, at its call (``zero3_unit``)."""

    zero3_unit = True

    def __init__(self, d_in, d_out):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype)


class TiledLinear(nn.Module):
    """A drop-in ``Linear(in_features, out_features)`` with tiled weights.

    Parameters are named as the JAX package's leaves: ``kernel_{i}_{j}``
    (through a tile module: ``tiles.kernel_{i}_{j}.kernel``) and
    ``bias_{j}``.  The tiles are initialized lecun-normal over the **full**
    fan-in (truncated at two standard deviations, flax's default), as if
    drawn for the whole matrix, so tiling does not change the
    distribution."""

    def __init__(self, in_features, out_features, in_splits=1, out_splits=1, bias=True,
                 dtype=torch.float32, remat_each_tile=True, generator=None):
        super().__init__()
        if in_features % in_splits:
            raise ValueError(f"in_features {in_features} % in_splits {in_splits}")
        if out_features % out_splits:
            raise ValueError(f"out_features {out_features} % out_splits {out_splits}")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        self.dtype, self.remat_each_tile = dtype, remat_each_tile
        d_in, d_out = in_features // in_splits, out_features // out_splits
        self.tiles = nn.ModuleDict({f"kernel_{i}_{j}": _Tile(d_in, d_out)
                                    for i in range(in_splits) for j in range(out_splits)})
        self.biases = nn.ParameterDict(
            {f"bias_{j}": nn.Parameter(torch.zeros(d_out)) for j in range(out_splits)}
            if bias else {})
        std = (1.0 / math.sqrt(in_features)) / .87962566103423978
        with torch.no_grad():
            for tile in self.tiles.values():
                nn.init.trunc_normal_(tile.kernel, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)

    def forward(self, x):
        xs = x.to(self.dtype).chunk(self.in_splits, -1)
        outs = []
        for j in range(self.out_splits):
            acc = None
            for i in range(self.in_splits):
                tile = self.tiles[f"kernel_{i}_{j}"]
                part = (checkpoint(tile, xs[i], use_reentrant=False,
                                   preserve_rng_state=False)
                        if self.remat_each_tile and torch.is_grad_enabled() else tile(xs[i]))
                acc = part if acc is None else acc + part
            if self.biases:
                acc = acc + self.biases[f"bias_{j}"].to(acc.dtype)
            outs.append(acc)
        return torch.cat(outs, -1)

    def tile_tree(self):
        """The tiles and biases under the JAX package's leaf names."""
        tree = {name: tile.kernel for name, tile in self.tiles.items()}
        tree.update(self.biases.items())
        return tree

    @staticmethod
    def assemble_full_kernel(params, in_splits, out_splits):
        """The [in, out] block matrix of the tiles ``params[kernel_{i}_{j}]``
        (the JAX package's function: checkpoint export, parity tests)."""
        return torch.cat([torch.cat([params[f"kernel_{i}_{j}"] for i in range(in_splits)], 0)
                          for j in range(out_splits)], 1)
