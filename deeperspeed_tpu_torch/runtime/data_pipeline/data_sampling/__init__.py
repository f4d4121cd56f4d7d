from .data_sampler import DeeperSpeedDataSampler  # noqa: F401
from .indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder  # noqa: F401
