from .activations import bias_gelu, gelu_tanh  # noqa: F401
from .normalize import layer_norm, rms_norm  # noqa: F401
from .rope import apply_rotary_pos_emb, rotary_tables  # noqa: F401
from .softmax import fused_softmax  # noqa: F401
