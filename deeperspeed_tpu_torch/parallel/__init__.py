from .topology import (  # noqa: F401
    MeshTopology,
    ProcessTopology,
    axis_size,
    get_mesh,
    set_mesh,
)
