"""Checkpoint tools (counterpart of ``deeperspeed_tpu/checkpoint/``): the
offline inspector, the fp32 export, the universal exports and imports, and
the flax msgpack codec the checkpoint files are written in."""

from .deeperspeed_checkpoint import DeeperSpeedCheckpoint  # noqa: F401
from .universal import ds_to_universal, load_universal_state  # noqa: F401
from .reference_universal import (  # noqa: F401
    export_reference_universal,
    import_neox_layer_checkpoint,
    import_reference_universal,
)
from .zero_to_fp32 import get_fp32_state_dict_from_checkpoint  # noqa: F401
