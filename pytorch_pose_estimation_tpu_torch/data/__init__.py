"""Host data layer: COCO annotation index, the SBP instance DB and its
threaded train and val loaders.  Augmentation and targets run on the
device (``ops/``)."""

from .coco import COCO_KPT_SIGMAS, CocoAnnotations
from .pipeline import HostLoader, collate, pad_batch
from .sbp_dataset import SBPCOCODataModule, load_sbp_instance_db

__all__ = [
    "COCO_KPT_SIGMAS",
    "CocoAnnotations",
    "HostLoader",
    "SBPCOCODataModule",
    "collate",
    "load_sbp_instance_db",
    "pad_batch",
]
