from .decode import DecodeSBP, decode_sbp, decode_sbp_batch, decode_sbp_fast
from .image import (AugmentDraws, augment_batch, augment_batch_core,
                    normalize_batch, sample_augment)
from .targets import SBPHeatmapGenerator, sbp_heatmaps, sbp_heatmaps_batch

__all__ = [
    "AugmentDraws",
    "DecodeSBP",
    "SBPHeatmapGenerator",
    "augment_batch",
    "augment_batch_core",
    "decode_sbp",
    "decode_sbp_batch",
    "decode_sbp_fast",
    "normalize_batch",
    "sample_augment",
    "sbp_heatmaps",
    "sbp_heatmaps_batch",
]
