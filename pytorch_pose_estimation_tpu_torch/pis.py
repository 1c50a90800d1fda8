"""PIS (Passenger Interaction System) behaviour rules on decoded joints.

Counterpart of pytorch_pose_estimation_tpu/pis.py (reference:
utils/sbp_pis_utils.py:105-148), with its arithmetic as it is: the
``int()`` truncation toward zero of the intersection, the ``+ 1e-6`` in the
gradient's denominator and the strict inequalities.  The rules compute in
the type of the joints they are given (numpy float32 in
``inference_sbp_pis``, float64 in the harnesses), as the JAX CLIs do.

* HandleGrip: is the right wrist on the grip side of a two-point handle
  line (a horizontal line-intersection test)?
* FallingDown: is the nose to shoulder-center gradient outside the upright
  band [neg_max, pos_min]?  True means upright ("normal").
"""

from __future__ import annotations

# the reference's camera constants (inference_sbp_pis.py:69-77): the
# handle line in 2560x1440 camera pixels and the upright gradient band
HANDLE_ROI = ((1220, 1300), (1600, 1130))
NEG_MAX = -1
POS_MIN = 8


class HandleGrip:
    """handle_roi: ((x1, y1), (x2, y2)), two points on the image."""

    def __init__(self, handle_roi):
        self.handle_roi = handle_roi

    def get_handle_grip_result(self, point) -> bool:
        """point: (x, y) of the wrist.  True = handle grip."""
        (ax, ay), (bx, by) = self.handle_roi
        gradient = (ay - by) / (ax - bx)
        y_intercept = ay - gradient * ax
        intersection_x = int((point[1] - y_intercept) / gradient)
        return point[0] > intersection_x


class FallingDown:
    """neg_max and pos_min bound the upright nose-to-shoulder gradient."""

    def __init__(self, neg_max: float, pos_min: float):
        self.neg_max = neg_max
        self.pos_min = pos_min

    def get_falling_down_result(self, point1, point2) -> bool:
        """point1, point2: (x, y) of the nose and the shoulder center.
        True = normal (upright)."""
        gradient = (point1[1] - point2[1]) / (point1[0] - point2[0] + 1e-6)
        return gradient < self.neg_max or self.pos_min < gradient
