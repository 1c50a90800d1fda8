"""PIS (Passenger Interaction System) data layer: the SBP top-down pipeline
on an 11-keypoint upper-body dataset whose annotation ``file_name`` fields
are already absolute paths, so no ``img_dir`` is joined (reference:
dataset/sbp_pis_dataset.py:18-185, the paths at :156).

Counterpart of pytorch_pose_estimation_tpu/data/pis_dataset.py.  The
loaders are SBP's: the native loader or cv2 by ``use_native`` (None = the
native loader when it is available), with the host CLAHE per sample.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .sbp_dataset import SBPCOCODataModule


class SBPPISDataModule(SBPCOCODataModule):
    """The SBP data module with absolute annotation paths, no
    ``img_dir``."""

    absolute_paths = True

    def __init__(self, train_path: Optional[str], val_path: Optional[str],
                 input_size, output_size, num_keypoints: int, sigma: float,
                 workers: int, batch_size: int,
                 class_labels: Sequence[str],
                 use_native: Optional[bool] = None, clahe_prob: float = 0.5,
                 seed: int = 0, cache_images: bool = False):
        super().__init__(train_path=train_path, val_path=val_path,
                         img_dir=None, input_size=input_size,
                         output_size=output_size,
                         num_keypoints=num_keypoints, sigma=sigma,
                         workers=workers, batch_size=batch_size,
                         class_labels=class_labels, use_native=use_native,
                         clahe_prob=clahe_prob, seed=seed,
                         cache_images=cache_images)
