"""Weights in and out of the port's models.

``from_jax_variables`` is the inverse of the JAX package's
``models/torch_import.py::import_torch_state_dict``: it maps flax
``{'params', 'batch_stats'}`` trees (numpy leaves) of an SBP or an SPM to a
state_dict with the reference's keys; the two differ only in the head's key
(``sbp_head.0.weight`` or ``spm_head.0.weight``, both flax's
``params['head']['kernel']``).  The darknet19 classifier
(``kind="classifier"``), whose stages sit at flax's top level beside
``classifier``, maps to the reference's classifier layout
(``stem.<pos>.*``, ``layer1..5.<pos>.*``, ``classifier.0.*``).  Conv kernels [kh, kw, I, O] and flax
transpose-kernel deconv kernels [kh, kw, O, I] both become torch layout by
the permutation (3, 2, 0, 1), the inverse of torch_import's (2, 3, 1, 0).
BN scale/bias/mean/var map to weight/bias/running_mean/running_var.

``load_state_dict_file`` reads what ``import_torch_checkpoint`` reads: a
bare state_dict, or a Lightning checkpoint whose ``state_dict`` keys carry
a ``model.`` prefix; and the model part of the port's own training
checkpoints (``train/checkpoint.py``).  Orbax checkpoints of the JAX
package load through ``from_jax_variables`` once a reader for them is
ported.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .darknet import STAGE_NAMES, STAGES

_BN = (("scale", "weight", "params"), ("bias", "bias", "params"),
       ("mean", "running_mean", "batch_stats"),
       ("var", "running_var", "batch_stats"))


def _kernel(w) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(w, np.float32),
                                          (3, 2, 0, 1))))


def _bn(variables: Mapping, path, prefix: str, out: dict) -> None:
    for flax_name, torch_name, collection in _BN:
        node = variables[collection]
        for p in path:
            node = node[p]
        out[f"{prefix}.{torch_name}"] = torch.from_numpy(
            np.array(node["bn"][flax_name], np.float32))
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv_bn(variables: Mapping, path, prefix: str, out: dict) -> None:
    node = variables["params"]
    for p in path:
        node = node[p]
    out[f"{prefix}.conv.weight"] = _kernel(node["conv"]["kernel"])
    _bn(variables, path, f"{prefix}.bn", out)


def from_jax_variables(variables: Mapping, kind: str = "sbp"
                       ) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the JAX SBP, SPM or darknet19
    classifier (``kind`` 'sbp', 'spm' or 'classifier') -> the port's
    state_dict of that model."""
    if kind not in ("sbp", "spm", "classifier"):
        raise ValueError(f"kind must be 'sbp', 'spm' or 'classifier', got "
                         f"{kind!r}")
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    for s, (name, table) in enumerate(zip(STAGE_NAMES, STAGES)):
        conv_i = 0
        for pos, entry in enumerate(table):
            if entry == "M":
                continue
            if kind == "classifier":
                _conv_bn(variables, (name, f"conv{conv_i}"),
                         f"{name}.{pos}", out)
            else:
                _conv_bn(variables, ("backbone", name, f"conv{conv_i}"),
                         f"backbone_features_module.{s}.{pos}", out)
            conv_i += 1
    if kind == "classifier":
        _conv_bn(variables, ("classifier",), "classifier.0", out)
        return out
    for i in (1, 2, 3):
        name = f"deconv_{i}"
        out[f"{name}.0.weight"] = _kernel(params[name]["deconv"]["kernel"])
        _bn(variables, (name,), f"{name}.1", out)
    out[f"{kind}_head.0.weight"] = _kernel(params["head"]["kernel"])
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a bare state_dict, a Lightning checkpoint (``model.``
    prefixes stripped) or the model of a training checkpoint from a torch
    file."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob and "optimizer" in blob:
        return blob["model"]
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) \
        else blob
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in state_dict.items()}
