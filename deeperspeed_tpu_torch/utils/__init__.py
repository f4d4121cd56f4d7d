from .logging import log_dist, logger  # noqa: F401
