"""Weights and optimizer state in and out of the port's models.

``from_jax_variables`` is the inverse of the JAX package's
``models/torch_import.py::import_torch_state_dict``: it maps flax
``{'params', 'batch_stats'}`` trees (numpy leaves) of an SBP or an SPM to a
state_dict with the reference's keys; the two differ only in the head's key
(``sbp_head.0.weight`` or ``spm_head.0.weight``, both flax's
``params['head']['kernel']``).  A backbone-only tree (the JAX
``extract_backbone``: ``params`` and ``batch_stats`` hold ``backbone``
alone) maps to the ``backbone_features_module.*`` entries alone.  The
darknet19 classifier (``kind="classifier"``), whose stages sit at flax's
top level beside ``classifier``, maps to the reference's classifier layout
(``stem.<pos>.*``, ``layer1..5.<pos>.*``, ``classifier.0.*``).  Conv
kernels [kh, kw, I, O] and flax transpose-kernel deconv kernels
[kh, kw, O, I] both become torch layout by the permutation (3, 2, 0, 1),
the inverse of torch_import's (2, 3, 1, 0).  BN scale/bias/mean/var map to
weight/bias/running_mean/running_var.

``from_jax_opt_state`` maps an optax chain's state, flattened to plain
numpy (``{'count': n, 'trace' | 'mu' | 'nu': params-shaped tree}``), to
the ``state_dict`` of the port's optimizer over the same model
(``optim.ChainOptimizer``): each moment leaf goes where its parameter's
weight goes, by the same permutation.

``load_state_dict_file`` reads what ``import_torch_checkpoint`` reads: a
bare state_dict, or a Lightning checkpoint whose ``state_dict`` keys carry
a ``model.`` prefix; and the model part of the port's own training
checkpoints (``train/checkpoint.py``).  The JAX package's orbax
checkpoints are directories, which the port does not read: the JAX host
converts them with ``tools/orbax_to_torch.py`` (``refuse_directory``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .darknet import STAGE_NAMES, STAGES

ORBAX_TOOL = "tools/orbax_to_torch.py"
_BN_PARAMS = (("scale", "weight"), ("bias", "bias"))
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))
MOMENTS = ("trace", "mu", "nu")  # optax's state fields, the port's keys


def refuse_directory(path: str, what: str = "checkpoint") -> None:
    """Raise a ValueError naming the converter when ``path`` is a
    directory (an orbax checkpoint of the JAX package): the port reads
    torch files only."""
    if os.path.isdir(path):
        raise ValueError(
            f"{what} {path} is a directory (an orbax checkpoint of the JAX "
            f"package?); the port reads torch files only: convert it on the "
            f"JAX host with `python {ORBAX_TOOL} --cfg <yaml> --src {path} "
            f"--out <file>`")


def _kernel(w) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(w, np.float32),
                                          (3, 2, 0, 1))))


def _layers(params: Mapping, kind: str
            ) -> Iterator[Tuple[tuple, str, str, str]]:
    """(flax path, torch prefix, kernel's module, BN's module) of every
    layer of the tree, in the model's order.  A pose tree without deconvs
    and head (a backbone-only tree) yields the backbone's layers alone."""
    for s, (name, table) in enumerate(zip(STAGE_NAMES, STAGES)):
        conv_i = 0
        for pos, entry in enumerate(table):
            if entry == "M":
                continue
            if kind == "classifier":
                yield (name, f"conv{conv_i}"), f"{name}.{pos}", "conv", "bn"
            else:
                yield (("backbone", name, f"conv{conv_i}"),
                       f"backbone_features_module.{s}.{pos}", "conv", "bn")
            conv_i += 1
    if kind == "classifier":
        yield ("classifier",), "classifier.0", "conv", "bn"
        return
    if "head" not in params and not any(
            f"deconv_{i}" in params for i in (1, 2, 3)):
        return  # backbone-only
    for i in (1, 2, 3):
        yield (f"deconv_{i}",), f"deconv_{i}", "0", "1"


def _node(tree: Mapping, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def _check_kind(kind: str) -> None:
    if kind not in ("sbp", "spm", "classifier"):
        raise ValueError(f"kind must be 'sbp', 'spm' or 'classifier', got "
                         f"{kind!r}")


def _param_leaves(params: Mapping, kind: str
                  ) -> Iterator[Tuple[str, tuple, bool]]:
    """(torch name, flax path, is a kernel) of every parameter leaf."""
    for path, prefix, conv, bn in _layers(params, kind):
        flax_conv = "deconv" if conv == "0" else "conv"
        yield f"{prefix}.{conv}.weight", path + (flax_conv, "kernel"), True
        for flax_name, torch_name in _BN_PARAMS:
            yield f"{prefix}.{bn}.{torch_name}", path + ("bn", flax_name), \
                False
    if kind != "classifier" and "head" in params:
        yield f"{kind}_head.0.weight", ("head", "kernel"), True


def map_params(params: Mapping, kind: str = "sbp",
               partial: bool = False) -> Dict[str, torch.Tensor]:
    """A params-shaped flax tree (the weights, or an optimizer moment of
    them) -> {torch parameter name: tensor}.  ``partial``: top-level
    subtrees the tree lacks (an optimizer's frozen ones) are left out."""
    _check_kind(kind)
    out: Dict[str, torch.Tensor] = {}
    for name, path, kernel in _param_leaves(params, kind):
        if partial and path[0] not in params:
            continue
        leaf = _node(params, path)
        out[name] = _kernel(leaf) if kernel else torch.from_numpy(
            np.array(leaf, np.float32))
    return out


def from_jax_variables(variables: Mapping, kind: str = "sbp"
                       ) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of the JAX SBP, SPM or darknet19
    classifier (``kind`` 'sbp', 'spm' or 'classifier'), or of the backbone
    alone -> the port's state_dict of that model (or its backbone's
    entries)."""
    params, stats = variables["params"], variables["batch_stats"]
    out = map_params(params, kind)
    for path, prefix, _, bn in _layers(params, kind):
        for flax_name, torch_name in _BN_STATS:
            out[f"{prefix}.{bn}.{torch_name}"] = torch.from_numpy(np.array(
                _node(stats, path + ("bn", flax_name)), np.float32))
        out[f"{prefix}.{bn}.num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long)
    return out


def from_jax_opt_state(opt_state: Mapping, model: nn.Module,
                       optimizer: torch.optim.Optimizer,
                       kind: str = "sbp") -> dict:
    """optax's state of the chain that trained the JAX twin of ``model``,
    flattened to ``{'count': n, name: params-shaped tree}`` for the names
    in ``MOMENTS`` it holds -> the ``state_dict()`` of ``optimizer`` (the
    port's optimizer over ``model``, built from the same config) at that
    state.  Parameters are indexed in the optimizer's own order.  A frozen
    subtree (``freeze``) is absent from the trees, as optax's
    ``set_to_zero`` keeps no state for it, and from the optimizer."""
    names = {id(p): n for n, p in model.named_parameters()}
    ordered = [names[id(p)] for g in optimizer.param_groups
               for p in g["params"]]
    moments = {k: map_params(tree, kind, partial=True)
               for k, tree in opt_state.items() if k != "count"}
    unknown = set(moments) - set(MOMENTS)
    if unknown:
        raise ValueError(f"optimizer state fields {sorted(unknown)} are not "
                         f"in {MOMENTS}")
    for k, m in moments.items():
        if set(m) != set(ordered):
            raise ValueError(
                f"the {k!r} tree holds {len(m)} parameters, the optimizer "
                f"{len(ordered)}: missing {sorted(set(ordered) - set(m))[:4]}"
                f", extra {sorted(set(m) - set(ordered))[:4]}")
    out = optimizer.state_dict()
    out["state"] = {i: {k: m[name] for k, m in moments.items()}
                    for i, name in enumerate(ordered)}
    out["count"] = int(opt_state["count"])
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a bare state_dict, a Lightning checkpoint (``model.``
    prefixes stripped) or the model of a training checkpoint from a torch
    file; a directory raises (``refuse_directory``)."""
    refuse_directory(path)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model" in blob and "optimizer" in blob:
        return blob["model"]
    state_dict = blob.get("state_dict", blob) if isinstance(blob, dict) \
        else blob
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in state_dict.items()}
