"""Rank bodies of tests/test_torch_port_spatial.py.

``parallel.launch`` spawns the ranks (gloo, on the CPU) and runs
``rank_main(spec)`` in each; this module imports torch and the port only,
so a rank starts without JAX.
"""

import torch
from torch import nn

from pytorch_pose_estimation_tpu_torch import parallel
from pytorch_pose_estimation_tpu_torch.models import SBP, SPM
from pytorch_pose_estimation_tpu_torch.models.layers import (ConvBnRelu,
                                                             DeconvBnRelu,
                                                             max_pool_2x2)

K = 17


def spatial_stack() -> nn.Sequential:
    """tests/test_parallel.py's SpatialStack in the port's layers: conv,
    pool, conv, deconv, 1x1 conv (flax's ConvBnAct_0, max_pool,
    ConvBnAct_1, DeconvBnRelu_0, ConvBnAct_2)."""
    return nn.Sequential(ConvBnRelu(3, 8, 3), max_pool_2x2(),
                         ConvBnRelu(8, 16, 3), DeconvBnRelu(16, 8),
                         ConvBnRelu(8, 4, 1))


BUILD = {"stack": spatial_stack, "sbp": lambda: SBP(K),
         "spm": lambda: SPM(K)}


def load(name: str, path: str) -> nn.Module:
    model = BUILD[name]()
    model.load_state_dict(torch.load(path, weights_only=True))
    return model.eval()


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def rank_main(spec: dict) -> dict:
    """Each model's rows of this rank through ``spatial_forward``, their
    gather and the exchange counts; then the refusals on several ranks."""
    out = {}
    # torch's native CPU convolutions: oneDNN picks its algorithm by shape
    torch.backends.mkldnn.enabled = False
    with torch.no_grad():
        for name, path in spec["models"].items():
            model = load(name, path)
            rows = parallel.spatial_rows(torch.from_numpy(
                spec["inputs"][name]))
            stats = {}
            y = parallel.spatial_forward(model, rows, stats)
            out[name] = {"rows": y, "gathered": parallel.gather_spatial(y),
                         "stats": stats}
        sbp = load("sbp", spec["models"]["sbp"])
        x = torch.from_numpy(spec["inputs"]["sbp"])
        errors = {
            "height": _refusal(lambda: parallel.spatial_forward(
                sbp, parallel.spatial_rows(x[:, :, :x.shape[2] // 2]))),
            "train": _refusal(lambda: parallel.spatial_forward(
                sbp.train(), parallel.spatial_rows(x)))}
    return {"rank": parallel.rank(), "out": out, "errors": errors}
