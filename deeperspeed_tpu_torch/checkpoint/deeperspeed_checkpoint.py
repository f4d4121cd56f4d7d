"""Offline checkpoint inspector (counterpart of
``deeperspeed_tpu/checkpoint/deeperspeed_checkpoint.py``): open a checkpoint
directory of either package without an engine, list its tags, read its
metadata, and read its parameter and optimizer trees.

The files hold whole (unpartitioned) arrays, so nothing is stitched from
per-rank shards: a tree read here goes to any world size or ZeRO stage.
"""

import json
import os
import re

from ..runtime.checkpoint_engine.checkpoint_engine import read_file_bytes
from ..runtime.checkpointing import ENGINE_FILE, MODEL_FILE, OPTIM_FILE, read_latest_tag
from .msgpack_codec import decode


def _msgpack_restore(path):
    return decode(read_file_bytes(path))


def flatten_state_dict(tree, prefix="", sep="."):
    """Nested dict tree -> {dotted/path: leaf} (torch-state-dict-shaped)."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            flat.update(flatten_state_dict(v, key, sep))
    else:
        flat[prefix] = tree
    return flat


class DeeperSpeedCheckpoint:
    """Read-only view of a ``save_checkpoint`` directory."""

    def __init__(self, ckpt_dir, tag=None):
        self.root = ckpt_dir
        if tag is None:
            tag = read_latest_tag(ckpt_dir)
            if tag is None:
                tags = self.tags(ckpt_dir)
                if not tags:
                    raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
                tag = tags[-1]
        self.tag = tag
        self.dir = os.path.join(ckpt_dir, str(tag))
        if not os.path.isdir(self.dir):
            raise FileNotFoundError(f"checkpoint dir {self.dir} does not exist")

    @staticmethod
    def tags(ckpt_dir):
        # natural sort so global_step10 > global_step2
        def natural(name):
            return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]

        out = []
        for name in sorted(os.listdir(ckpt_dir), key=natural):
            if os.path.isfile(os.path.join(ckpt_dir, name, ENGINE_FILE)):
                out.append(name)
        return out

    @property
    def meta(self):
        with open(os.path.join(self.dir, ENGINE_FILE)) as f:
            return json.load(f)

    def model_state_tree(self):
        """fp32 master params as a nested dict of numpy arrays."""
        return _msgpack_restore(os.path.join(self.dir, MODEL_FILE))

    def optimizer_state_tree(self):
        return _msgpack_restore(os.path.join(self.dir, OPTIM_FILE))

    def model_state_dict(self, sep="."):
        return flatten_state_dict(self.model_state_tree(), sep=sep)

    def num_parameters(self):
        return sum(int(v.size) for v in self.model_state_dict().values())

    def parameter_names(self):
        return sorted(self.model_state_dict().keys())
