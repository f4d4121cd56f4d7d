from .topology import (  # noqa: F401
    MeshTopology,
    PipeModelDataParallelTopology,
    ProcessTopology,
    axis_size,
    get_mesh,
    set_mesh,
)
