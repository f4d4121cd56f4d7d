"""Inference, PyTorch port: the v1 engine (``InferenceEngine``, cached
generation with weight-only quantization) and its config; the paged
serving engine and its scheduler are in ``inference.v2``."""

from .config import DeeperSpeedInferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
