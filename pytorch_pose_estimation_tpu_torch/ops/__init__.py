from .decode import DecodeSBP, decode_sbp, decode_sbp_batch, decode_sbp_fast
from .image import normalize_batch
from .targets import SBPHeatmapGenerator, sbp_heatmaps, sbp_heatmaps_batch

__all__ = [
    "DecodeSBP",
    "SBPHeatmapGenerator",
    "decode_sbp",
    "decode_sbp_batch",
    "decode_sbp_fast",
    "normalize_batch",
    "sbp_heatmaps",
    "sbp_heatmaps_batch",
]
