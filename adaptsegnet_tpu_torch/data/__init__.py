"""Host-side data: PIL decode with the reference's exact preprocessing, the
GTA5, Synscapes and Cityscapes datasets, the prefetching loader, devkit
lists and synthetic fixtures."""

from adaptsegnet_tpu_torch.data.cityscapes import CityscapesDataset
from adaptsegnet_tpu_torch.data.gta5 import GTA5Dataset
from adaptsegnet_tpu_torch.data.pipeline import PrefetchLoader
from adaptsegnet_tpu_torch.data.preprocessing import (
    IMG_MEAN_BGR,
    preprocess_image,
)
from adaptsegnet_tpu_torch.data.synscapes import SynscapesDataset

__all__ = ["CityscapesDataset", "GTA5Dataset", "IMG_MEAN_BGR",
           "PrefetchLoader", "SynscapesDataset", "preprocess_image"]
