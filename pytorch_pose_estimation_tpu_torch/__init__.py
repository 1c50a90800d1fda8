"""PyTorch/CUDA port of the pose-estimation framework, for one NVIDIA H100.

The JAX package ``pytorch_pose_estimation_tpu`` stays the reference; this
package mirrors its module names and imports nothing of it, and no jax.
Plain tensor code is PyTorch; the JAX package's two Pallas kernels are
CUDA C++ kernels under ``csrc/``, built with nvcc at first use
(``ops/kernels.py``).

Ported so far, the SBP serving and eval path: ``models`` (Darknet19 + SBP),
``ops`` (targets, decode, normalize), ``losses``, ``train`` (eval step,
predictor, validate), ``data`` (COCO index, val loader), ``eval`` (OKS AP).
cv2 and PyYAML are imported only where an image or a config file is read.
"""

__version__ = "0.1.0"
