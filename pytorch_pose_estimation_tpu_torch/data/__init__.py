"""Host data layer: COCO annotation index, the SBP instance DB (and its
PIS variant with absolute paths), the SPM image DB, the ImageFolder
classification data and their threaded train and val loaders (cv2, or the
native C++ JPEG loader, ``native_loader``).  Augmentation and targets run
on the device (``ops/``)."""

from . import native_loader
from .classifier_dataset import ImageFolderDataModule
from .coco import COCO_KPT_SIGMAS, CocoAnnotations
from .pipeline import HostLoader, collate, pad_batch
from .pis_dataset import SBPPISDataModule
from .sbp_dataset import SBPCOCODataModule, load_sbp_instance_db
from .spm_dataset import SPMCOCODataModule, load_spm_image_db

__all__ = [
    "COCO_KPT_SIGMAS",
    "CocoAnnotations",
    "HostLoader",
    "ImageFolderDataModule",
    "SBPCOCODataModule",
    "SBPPISDataModule",
    "SPMCOCODataModule",
    "collate",
    "load_sbp_instance_db",
    "load_spm_image_db",
    "native_loader",
    "pad_batch",
]
