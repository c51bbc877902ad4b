"""Host-side data for the eval slice: PIL decode with the reference's exact
preprocessing, the Cityscapes dataset, devkit lists and synthetic fixtures."""

from adaptsegnet_tpu_torch.data.cityscapes import CityscapesDataset
from adaptsegnet_tpu_torch.data.preprocessing import (
    IMG_MEAN_BGR,
    preprocess_image,
)

__all__ = ["CityscapesDataset", "IMG_MEAN_BGR", "preprocess_image"]
