"""YAML experiment-config loading.

Counterpart of pytorch_pose_estimation_tpu/config.py (reference:
utils/yaml_helper.py:22-30): flat-dict YAML loaded with a SafeLoader patched
so scientific-notation scalars like ``1e-3`` parse as floats (stock PyYAML
1.1 parses them as strings).  PyYAML is imported when a file is read, so
the package imports without it.  ``make_model_name`` reproduces
utils/utility.py:13.
"""

from __future__ import annotations

import re

# YAML 1.1's float regex requires a digit after the '.', so '1e-3' is a str.
_FLOAT = re.compile(
    r"""^(?:
     [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)


def load_yaml_file(path: str) -> dict:
    import yaml

    class _ConfigLoader(yaml.SafeLoader):
        """SafeLoader subclass so the resolver patch stays local."""

    _ConfigLoader.add_implicit_resolver("tag:yaml.org,2002:float", _FLOAT,
                                        list("-+0123456789."))
    with open(path, "r") as f:
        return yaml.load(f, Loader=_ConfigLoader)


def get_configs(path: str) -> dict:
    """Load a flat experiment config dict from a YAML file."""
    return load_yaml_file(path)


def make_model_name(cfg: dict) -> str:
    """Log/checkpoint directory name: '<model>_<dataset_name>'."""
    return cfg["model"] + "_" + cfg["dataset_name"]
