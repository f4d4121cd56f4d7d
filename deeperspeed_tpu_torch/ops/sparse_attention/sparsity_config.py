"""Block-sparsity pattern configurations (the port's own copy of
``deeperspeed_tpu/ops/sparse_attention/sparsity_config.py``, plain numpy).

The same pattern families as the reference's
``ops/sparse_attention/sparsity_config.py`` (Dense / Fixed / Variable /
BigBird / BSLongformer): ``make_layout(seq_len)`` returns a
``[num_heads, nq, nk]`` uint8 layout over attention blocks, which
``sparse_attention`` hands to kernel B10 as an int32 table on the card.
Each layout, the ``RandomState(seed)`` draws of Variable and BigBird
included, equals the JAX package's bit for bit.  The block defaults to 128
tokens, as there (the reference's Triton stack used 16).

Pattern semantics follow the reference:

* **Fixed** -- attention within fixed local windows of ``num_local_blocks``;
  the last ``num_global_blocks`` of each window attend / are attended
  globally (unidirectional variant keeps the lower triangle).
* **Variable** -- like Fixed with per-window sizes + explicit global block
  indices + optional random blocks.
* **BigBird** -- random + sliding window + global-edge blocks.
* **BSLongformer** -- sliding window + global blocks at the sequence start.
"""

import numpy as np


class SparsityConfig:
    def __init__(self, num_heads, block=128, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} must be divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), np.uint8)

    def propagate_first_head(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_local_blocks
        for h in range(self.num_layout_heads):
            # local windows
            for start in range(0, n, w):
                end = min(start + w, n)
                layout[h, start:end, start:end] = 1
            # global: last num_global_blocks of each window, rotated per head
            # (num_different_global_patterns)
            pat = (h % self.num_different_global_patterns)
            for start in range(0, n, w):
                end = min(start + w, n)
                first_g = end - (pat + 1) * self.num_global_blocks
                g0, g1 = max(start, first_g), max(start, first_g) + self.num_global_blocks
                g1 = min(g1, end)
                # vertical: every later block attends to the window's globals
                layout[h, end:, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
        layout = self.propagate_first_head(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=(4,),
                 global_block_indices=(0,), global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None)
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_layout_heads):
            # local windows of varying size (last size repeats)
            start = 0
            i = 0
            while start < n:
                w = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
                end = min(start + w, n)
                layout[h, start:end, start:end] = 1
                start, i = end, i + 1
            # globals
            for j, g in enumerate(self.global_block_indices):
                if self.global_block_end_indices:
                    g1 = self.global_block_end_indices[j]
                else:
                    g1 = g + 1
                g, g1 = min(g, n), min(g1, n)
                layout[h, :, g:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g:g1, :] = 1
            # random blocks
            for r in range(self.num_random_blocks):
                for q in range(n):
                    layout[h, q, rng.randint(0, n)] = 1
        layout = self.propagate_first_head(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        half = self.num_sliding_window_blocks // 2
        g = min(self.num_global_blocks, n)
        for h in range(self.num_layout_heads):
            for q in range(n):
                layout[h, q, max(0, q - half):min(n, q + half + 1)] = 1
                for _ in range(self.num_random_blocks):
                    layout[h, q, rng.randint(0, n)] = 1
            layout[h, :, :g] = 1
            layout[h, :g, :] = 1
        layout = self.propagate_first_head(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    def __init__(self, num_heads, block=128, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=(0,),
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None)
        assert attention in ("unidirectional", "bidirectional")
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        half = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for q in range(n):
                layout[h, q, max(0, q - half):min(n, q + half + 1)] = 1
            for j, g in enumerate(self.global_block_indices):
                g1 = (self.global_block_end_indices[j]
                      if self.global_block_end_indices else g + 1)
                g, g1 = min(g, n), min(g1, n)
                layout[h, :, g:g1] = 1
                layout[h, g:g1, :] = 1
        layout = self.propagate_first_head(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout
