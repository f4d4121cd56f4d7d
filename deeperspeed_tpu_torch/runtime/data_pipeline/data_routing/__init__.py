from .basic_layer import random_ltd_gather, random_ltd_scatter  # noqa: F401
from .scheduler import RandomLTDScheduler  # noqa: F401
