from .decode import (DecodeSBP, DecodeSPM, decode_sbp, decode_sbp_batch,
                     decode_sbp_fast, decode_spm, decode_spm_batch)
from .image import (AugmentDraws, PhotometricDraws, augment_batch,
                    augment_batch_core, normalize_batch, sample_augment,
                    sample_photometric, spm_photometric_core)
from .targets import (SBPHeatmapGenerator, SPMTargetGenerator, sbp_heatmaps,
                      sbp_heatmaps_batch, spm_displacements, spm_heatmaps,
                      spm_masks, spm_target)

__all__ = [
    "AugmentDraws",
    "DecodeSBP",
    "DecodeSPM",
    "PhotometricDraws",
    "SBPHeatmapGenerator",
    "SPMTargetGenerator",
    "augment_batch",
    "augment_batch_core",
    "decode_sbp",
    "decode_sbp_batch",
    "decode_sbp_fast",
    "decode_spm",
    "decode_spm_batch",
    "normalize_batch",
    "sample_augment",
    "sample_photometric",
    "sbp_heatmaps",
    "sbp_heatmaps_batch",
    "spm_displacements",
    "spm_heatmaps",
    "spm_masks",
    "spm_photometric_core",
    "spm_target",
]
