"""PyTorch/CUDA port of the pose-estimation framework, for one NVIDIA H100.

The JAX package ``pytorch_pose_estimation_tpu`` stays the reference; this
package mirrors its module names and imports nothing of it, and no jax.
Plain tensor code is PyTorch; the JAX package's two Pallas kernels are
CUDA C++ kernels under ``csrc/``, built with nvcc at first use
(``ops/kernels.py``).

Ported so far: SBP, SPM and PIS training, serving and eval, and the
darknet19 classifier pretrain.  ``models`` (Darknet19 features and
classifier, SBP, SPM), ``ops`` (augmentation, SBP and SPM targets and
decode, normalize), ``losses``, ``optim`` (optax-chain optimizers, LR
schedules), ``train`` (train and eval steps, state, checkpoints and weight
surgery, ``Trainer`` with the backbone warm start, predictor,
``load_for_inference``, validate), ``data`` (COCO index, SBP, PIS and SPM
loaders, ImageFolder), ``eval`` (OKS AP), ``pis`` (behaviour rules),
``vis``, ``registry``, ``utility``, and the CLI modules ``train_sbp``,
``test_sbp``, ``inference_sbp``, ``train_spm``, ``test_spm``,
``inference_spm``, ``train_sbp_pis``, ``saving_weights``,
``inference_sbp_pis``, ``pis_handle_test_code``,
``pis_falling_down_test_code`` and ``train_classifier``.  cv2, PyYAML and
tensorboardX are imported only where an image, a config file or a log is
read or written.
"""

__version__ = "0.1.0"
