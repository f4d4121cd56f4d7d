from .checkpoint_engine import (  # noqa: F401
    MANIFEST_FILE,
    AsyncCheckpointEngine,
    CheckpointEngine,
    NativeCheckpointEngine,
    atomic_write_bytes,
    file_sha256,
    get_checkpoint_engine,
    read_manifest,
    verify_manifest,
)
