from .cocoeval import KeypointEvaluator
from .metrics import SBPmAPCOCO, SPMmAPCOCO

__all__ = ["KeypointEvaluator", "SBPmAPCOCO", "SPMmAPCOCO"]
