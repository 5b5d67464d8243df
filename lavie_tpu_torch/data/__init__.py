"""The fork's datasets, video transforms and loader (port of lavie_tpu.data)."""

from lavie_tpu_torch.data.datasets import (
    MSVDDataset,
    MSRVTTDataset,
    UCF101Dataset,
    VideoFolderDataset,
)
from lavie_tpu_torch.data.loader import DataLoader

__all__ = [
    "MSVDDataset",
    "MSRVTTDataset",
    "UCF101Dataset",
    "VideoFolderDataset",
    "DataLoader",
]
