from .cocoeval import KeypointEvaluator
from .metrics import SBPmAPCOCO, SBPmAPPIS, SPMmAPCOCO

__all__ = ["KeypointEvaluator", "SBPmAPCOCO", "SBPmAPPIS", "SPMmAPCOCO"]
