from .cocoeval import KeypointEvaluator
from .metrics import SBPmAPCOCO

__all__ = ["KeypointEvaluator", "SBPmAPCOCO"]
