"""Host-side visualization: decoded joints and limbs drawn on images.

Counterpart of pytorch_pose_estimation_tpu/vis.py (reference:
utils/sbp_utils.py:191-252, the COCO 16-limb skeleton with left/right
colors; utils/spm_utils.py:252-279, SPM root and keypoint dots;
utils/sbp_pis_utils.py:49-103, the 9-limb upper-body PIS skeleton).  cv2 is
imported where an image is drawn.
"""

from __future__ import annotations

import numpy as np

LIMB_COLORS = [
    (0, 102, 102),   # right face
    (102, 0, 102),   # left face
    (0, 204, 0),     # right arm
    (204, 0, 0),     # left arm
    (0, 102, 0),     # right leg
    (102, 0, 0),     # left leg
    (0, 0, 0),       # torso / others
]

# (joint_a, joint_b, color index) for the 17-keypoint COCO skeleton
COCO_LIMBS = [
    (0, 1, 1), (0, 2, 0), (1, 3, 1), (2, 4, 0),
    (5, 7, 3), (6, 8, 2), (7, 9, 3), (8, 10, 2),
    (11, 13, 5), (12, 14, 4), (13, 15, 5), (14, 16, 4),
    (5, 6, 6), (5, 11, 6), (6, 12, 6), (11, 12, 6),
]

# 11-keypoint upper-body PIS skeleton
PIS_LIMBS = [
    (0, 1, 1), (0, 2, 0), (1, 3, 1), (2, 4, 0),
    (5, 7, 3), (6, 8, 2), (7, 9, 3), (8, 10, 2), (5, 6, 6),
]


def _draw_skeleton(img, joints, limbs, line_px, dot_px):
    import cv2

    tagged = img.copy()
    joints = np.asarray(joints)
    for (a, b, c) in limbs:
        j1, j2 = joints[a], joints[b]
        if j1[-1] < 0 or j2[-1] < 0:
            continue
        cv2.line(tagged, (int(j1[0]), int(j1[1])), (int(j2[0]), int(j2[1])),
                 LIMB_COLORS[c], line_px)
    for (x, y, conf) in joints:
        if conf < 0:
            continue
        cv2.circle(tagged, (int(x), int(y)), dot_px, (0, 0, 255), -1)
    return tagged


def get_coco_tagged_img_sbp(img: np.ndarray, joints) -> np.ndarray:
    """joints: [K, 3] (x, y, conf); conf < 0 marks missing."""
    return _draw_skeleton(img, joints, COCO_LIMBS, 2, 2)


def get_pis_tagged_img_sbp(img: np.ndarray, joints) -> np.ndarray:
    return _draw_skeleton(img, joints, PIS_LIMBS, 4, 4)


def get_tagged_img_spm(img: np.ndarray, root_joints, keypoints_joint
                       ) -> np.ndarray:
    """root_joints: [M, >=2]; keypoints_joint: [M, K, >=2]; joints at
    (x<=0 and y<=0) are skipped."""
    import cv2

    tagged = img.copy()
    for person in np.asarray(keypoints_joint):
        for joint in person:
            x, y = joint[0], joint[1]
            if x <= 0.0 and y <= 0.0:
                continue
            cv2.circle(tagged, (int(x), int(y)), 3, (255, 0, 0), -1)
    for root in np.asarray(root_joints):
        cv2.circle(tagged, (int(root[0]), int(root[1])), 3, (0, 0, 255), -1)
    return tagged
