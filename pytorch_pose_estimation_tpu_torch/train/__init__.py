from .checkpoint import (CheckpointManager, extract_backbone,
                         load_backbone, load_pretrained, next_version_dir,
                         restore_checkpoint, restore_checkpoint_flexible,
                         restore_params, save_checkpoint, save_params)
from .device_cache import DeviceDataCache, build_device_cache
from .state import TrainState
from .steps import (make_sbp_eval_step, make_sbp_steps, make_spm_eval_step,
                    make_spm_steps)
from .trainer import (Trainer, apply_precision_config, build_metric,
                      build_model, load_for_inference, load_model,
                      load_sbp_predictor, resolve_device, to_device,
                      validate)

__all__ = [
    "CheckpointManager",
    "DeviceDataCache",
    "TrainState",
    "Trainer",
    "apply_precision_config",
    "build_device_cache",
    "build_metric",
    "build_model",
    "extract_backbone",
    "load_backbone",
    "load_for_inference",
    "load_model",
    "load_pretrained",
    "load_sbp_predictor",
    "make_sbp_eval_step",
    "make_sbp_steps",
    "make_spm_eval_step",
    "make_spm_steps",
    "next_version_dir",
    "resolve_device",
    "restore_checkpoint",
    "restore_checkpoint_flexible",
    "restore_params",
    "save_checkpoint",
    "save_params",
    "to_device",
    "validate",
]
