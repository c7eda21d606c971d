from pggan_tpu_torch.data.datasets import DepthDataset, SyntheticDataset
from pggan_tpu_torch.data.loader import DataIterator, InfiniteRandomSampler

__all__ = ["DepthDataset", "SyntheticDataset", "DataIterator",
           "InfiniteRandomSampler"]
