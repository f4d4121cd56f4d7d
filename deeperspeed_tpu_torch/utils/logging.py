"""Rank-aware logging (counterpart of ``deeperspeed_tpu/utils/logging.py``)."""

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name="DeeperSpeedTorch", level=logging.INFO):
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s", datefmt="%H:%M:%S"
    )
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(fmt)
    lg.addHandler(handler)
    return lg


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DST_LOG_LEVEL", "info").lower(), logging.INFO)
)


def _process_index():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log only on the given process indices (``None`` / ``[-1]`` = all).

    Mirrors the reference's ``log_dist`` rank filter semantics.
    """
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message):
    _warned = getattr(warning_once, "_warned", set())
    if message not in _warned:
        logger.warning(message)
        _warned.add(message)
        warning_once._warned = _warned


def print_json_dist(message, ranks=None, path=None):
    """Dump a json message from the given ranks to ``path`` (reference parity)."""
    import json

    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        message["rank"] = my_rank
        if path is not None:
            with open(path, "w") as f:
                json.dump(message, f)
        else:
            logger.info(json.dumps(message))
