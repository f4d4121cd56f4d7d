from .module import LayerSpec, PipelineModule, TiedLayerSpec  # noqa: F401
from . import schedule  # noqa: F401
