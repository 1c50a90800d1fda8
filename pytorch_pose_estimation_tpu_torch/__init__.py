"""PyTorch/CUDA port of the pose-estimation framework, for one NVIDIA H100.

The JAX package ``pytorch_pose_estimation_tpu`` stays the reference; this
package mirrors its module names and imports nothing of it, and no jax.
Plain tensor code is PyTorch; the JAX package's two Pallas kernels are
CUDA C++ kernels under ``csrc/``, built with nvcc at first use
(``ops/kernels.py``).

Ported so far, SBP training, serving and eval: ``models`` (Darknet19 +
SBP), ``ops`` (augmentation, targets, decode, normalize), ``losses``,
``optim`` (optax-chain optimizers, LR schedules), ``train`` (train and eval
steps, state, checkpoints, ``Trainer``, predictor, validate), ``data``
(COCO index, train and val loaders), ``eval`` (OKS AP), and the
``train_sbp`` and ``test_sbp`` CLI modules.  cv2, PyYAML and tensorboardX
are imported only where an image, a config file or a log is written.
"""

__version__ = "0.1.0"
