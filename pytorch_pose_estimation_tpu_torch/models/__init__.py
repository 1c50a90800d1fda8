from .convert import (from_jax_opt_state, from_jax_variables,
                      load_state_dict_file, refuse_directory)
from .darknet import Darknet19, Darknet19Classifier, darknet19
from .initialize import lecun_normal_
from .layers import ConvBn, ConvBnAct, ConvBnRelu, DeconvBnRelu
from .sbp import SBP, PoseNet
from .spm import SPM
from .summary import count_params, print_summary, summarize

__all__ = [
    "ConvBn",
    "ConvBnAct",
    "ConvBnRelu",
    "Darknet19",
    "Darknet19Classifier",
    "DeconvBnRelu",
    "PoseNet",
    "SBP",
    "SPM",
    "count_params",
    "darknet19",
    "from_jax_opt_state",
    "from_jax_variables",
    "lecun_normal_",
    "load_state_dict_file",
    "print_summary",
    "refuse_directory",
    "summarize",
]
