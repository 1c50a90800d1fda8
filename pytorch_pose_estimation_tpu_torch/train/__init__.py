from .steps import make_sbp_eval_step
from .trainer import (apply_precision_config, build_metric, build_model,
                      load_model, load_sbp_predictor, resolve_device,
                      validate)

__all__ = [
    "apply_precision_config",
    "build_metric",
    "build_model",
    "load_model",
    "load_sbp_predictor",
    "make_sbp_eval_step",
    "resolve_device",
    "validate",
]
