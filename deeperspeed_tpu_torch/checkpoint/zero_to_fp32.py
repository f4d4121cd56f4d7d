"""A consolidated fp32 state dict from a checkpoint, without an engine
(counterpart of ``deeperspeed_tpu/checkpoint/zero_to_fp32.py``).  The files
already hold whole fp32 masters, so this is a read and a flatten:

    python -m deeperspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.npz>
"""

import argparse

import numpy as np

from .deeperspeed_checkpoint import DeeperSpeedCheckpoint


def get_fp32_state_dict_from_checkpoint(checkpoint_dir, tag=None):
    """{param_name: np.float32 array} from the newest (or given) tag."""
    ckpt = DeeperSpeedCheckpoint(checkpoint_dir, tag=tag)
    return {k: np.asarray(v, np.float32) for k, v in ckpt.model_state_dict().items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file, tag=None):
    state = get_fp32_state_dict_from_checkpoint(checkpoint_dir, tag=tag)
    np.savez(output_file, **state)
    return output_file


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file", help=".npz path for the fp32 weights")
    parser.add_argument("-t", "--tag", default=None)
    ns = parser.parse_args(args)
    convert_zero_checkpoint_to_fp32_state_dict(ns.checkpoint_dir, ns.output_file, tag=ns.tag)
    state = get_fp32_state_dict_from_checkpoint(ns.checkpoint_dir, tag=ns.tag)
    total = sum(v.size for v in state.values())
    print(f"wrote {len(state)} tensors / {total:,} params to {ns.output_file}")


if __name__ == "__main__":
    main()
