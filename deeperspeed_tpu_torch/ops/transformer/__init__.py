from .normalize import layer_norm, rms_norm  # noqa: F401
from .rope import apply_rotary_pos_emb, rotary_tables  # noqa: F401
