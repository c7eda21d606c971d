from pggan_tpu_torch.data.datasets import (
    DefaultImageFolderDataset,
    DepthDataset,
    FolderDataset,
    H5Dataset,
    OldH5Dataset,
    SoundImageDataset,
    SyntheticDataset,
)
from pggan_tpu_torch.data.loader import DataIterator, InfiniteRandomSampler

__all__ = ["DefaultImageFolderDataset", "DepthDataset", "FolderDataset",
           "H5Dataset", "OldH5Dataset", "SoundImageDataset",
           "SyntheticDataset", "DataIterator", "InfiniteRandomSampler"]
