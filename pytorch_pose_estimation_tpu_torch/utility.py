"""Small utilities (reference: utils/utility.py:3-20).

Counterpart of pytorch_pose_estimation_tpu/utility.py: ``make_model_name``
and ``set_parameter_requires_grad`` (the port's ``optim.freeze_subtrees``)
re-exported, and ``make_divisible``.
"""

from __future__ import annotations

from .config import make_model_name  # noqa: F401  (re-export)
from .optim import freeze_subtrees as set_parameter_requires_grad  # noqa: F401


def make_divisible(v, divisor: int = 8, min_value=None) -> int:
    """Round a channel count to a multiple of ``divisor``, never dropping
    more than 10% (the MobileNet rule)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
