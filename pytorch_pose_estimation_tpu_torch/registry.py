"""Name -> factory registries (reference: utils/module_select.py:7-35).

Counterpart of pytorch_pose_estimation_tpu/registry.py: ``get_model``
resolves backbone names (unknown names give None, the reference's
``.get()``); the optimizers and schedules live in ``optim`` and are
re-exported here.
"""

from __future__ import annotations

from .models.darknet import darknet19
from .optim import get_optimizer, get_scheduler  # noqa: F401  (re-export)

_MODELS = {
    "darknet19": darknet19,
}


def get_model(model_name: str):
    return _MODELS.get(model_name)


def register_model(name: str, factory) -> None:
    _MODELS[name] = factory
