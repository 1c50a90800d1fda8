"""PyTorch/CUDA port of the pose-estimation framework, for one NVIDIA H100.

The JAX package ``pytorch_pose_estimation_tpu`` stays the reference; this
package mirrors its module names and imports nothing of it, and no jax.
Plain tensor code is PyTorch; the JAX package's two Pallas kernels are
CUDA C++ kernels under ``csrc/``, built with nvcc at first use
(``ops/kernels.py``).

Ported so far: SBP and SPM training, serving and eval.  ``models``
(Darknet19, SBP, SPM), ``ops`` (augmentation, SBP and SPM targets and
decode, normalize), ``losses``, ``optim`` (optax-chain optimizers, LR
schedules), ``train`` (train and eval steps, state, checkpoints,
``Trainer``, predictor, ``load_for_inference``, validate), ``data`` (COCO
index, SBP and SPM loaders), ``eval`` (OKS AP), ``vis``, and the CLI
modules ``train_sbp``, ``test_sbp``, ``inference_sbp``, ``train_spm``,
``test_spm`` and ``inference_spm``.  cv2, PyYAML and tensorboardX are
imported only where an image, a config file or a log is read or written.
"""

__version__ = "0.1.0"
