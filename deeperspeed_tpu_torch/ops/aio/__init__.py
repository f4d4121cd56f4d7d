from .aio_handle import AsyncIOHandle, aio_available  # noqa: F401
