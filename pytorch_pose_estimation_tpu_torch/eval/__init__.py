from .cocoeval import KeypointEvaluator, evaluate_keypoints
from .metrics import SBPmAPCOCO, SBPmAPPIS, SPMmAPCOCO

__all__ = ["KeypointEvaluator", "SBPmAPCOCO", "SBPmAPPIS", "SPMmAPCOCO",
           "evaluate_keypoints"]
