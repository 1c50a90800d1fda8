"""Checkpoints in ``torch.save`` form, with the JAX package's directory and
selection semantics.

Counterpart of pytorch_pose_estimation_tpu/train/checkpoint.py (reference
behavior: train_sbp.py:55-67, Lightning ModelCheckpoint):
``saved/<model>_<dataset>/version_N/checkpoints/`` holds ``epoch=E-step=S``
snapshots, ``last`` and ``best`` (by val_loss), each a single file with a
``<name>.meta.json`` beside it ({"epoch", "step", "val_loss"}).  A
checkpoint holds {"step", "model", "optimizer", "meta"}: the model's
state_dict (the reference's keys), the optimizer's (its update count
included) and the same meta as the sidecar.

Every file is written under a temporary name and then renamed with
``os.replace``, so a kill in the middle of a save leaves the previous file
whole and only a ``*.tmp*`` file behind.  Under several ranks
(``parallel``), rank 0 makes the version directory and writes every file,
and each save ends in a barrier, so no rank reads a file before it is
whole; every rank restores.  Weight surgery (the reference's
saving_weights.py:22-42): ``extract_backbone`` and ``load_pretrained``;
``load_backbone`` overlays a backbone from either layout the framework
makes (a pose model's ``backbone_features_module.*`` or the darknet19
classifier's ``stem``, ``layer1`` .. ``layer5``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from torch import nn

from ..models import load_state_dict_file, refuse_directory
from ..models.darknet import STAGE_NAMES
from ..parallel import mesh
from .state import TrainState

_BACKBONE = "backbone_features_module."


def next_version_dir(save_dir: str, model_name: str) -> str:
    """A new ``<save_dir>/<model_name>/version_N`` with its
    ``checkpoints``; under several ranks rank 0 makes it and every rank
    gets its path."""
    path = None
    if mesh.is_main():
        base = os.path.join(save_dir, model_name)
        os.makedirs(base, exist_ok=True)
        n = 0
        while os.path.exists(os.path.join(base, f"version_{n}")):
            n += 1
        path = os.path.join(base, f"version_{n}")
        os.makedirs(os.path.join(path, "checkpoints"), exist_ok=True)
    return mesh.broadcast_object(path)


def _tmp(path: str) -> str:
    return f"{path}.tmp{os.getpid()}"


def _save_atomic(obj, path: str) -> None:
    tmp = _tmp(path)
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_meta(path: str, meta: dict) -> None:
    tmp = _tmp(path + ".meta.json")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".meta.json")


def save_checkpoint(path: str, state: TrainState,
                    meta: Optional[dict] = None) -> str:
    """Write ``state`` (and ``meta``, also as the sidecar) to ``path``;
    under several ranks rank 0 writes and every rank waits until it has."""
    path = os.path.abspath(path)
    meta = dict(meta or {"step": state.step})
    if mesh.is_main():
        _save_atomic(dict(state.state_dict(), meta=meta), path)
        _write_meta(path, meta)
    mesh.barrier()
    return path


class CheckpointManager:
    """save_epoch / save_last, and ``best`` by val_loss."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.best_val_loss = float("inf")
        self.best_path: Optional[str] = None

    def save_epoch(self, state: TrainState, epoch: int,
                   val_loss: Optional[float] = None) -> str:
        meta = {"epoch": epoch, "step": state.step, "val_loss": val_loss}
        path = save_checkpoint(os.path.join(
            self.ckpt_dir, f"epoch={epoch}-step={state.step}"), state, meta)
        if val_loss is not None and val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            best = os.path.join(self.ckpt_dir, "best")
            if mesh.is_main():
                shutil.copyfile(path, _tmp(best))
                os.replace(_tmp(best), best)
                _write_meta(best, meta)
            mesh.barrier()
            self.best_path = path
        return path

    def save_last(self, state: TrainState, epoch: int,
                  val_loss: Optional[float] = None) -> str:
        return save_checkpoint(
            os.path.join(self.ckpt_dir, "last"), state,
            {"epoch": epoch, "step": state.step, "val_loss": val_loss})


def _load(path: str) -> dict:
    refuse_directory(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> dict:
    """Load a full checkpoint into ``state`` (model, optimizer, step) in
    place; returns its meta."""
    blob = _load(path)
    state.load_state_dict(blob)
    return dict(blob.get("meta") or {})


def restore_checkpoint_flexible(path: str, state: TrainState) -> dict:
    """A full checkpoint, or else a bare model state_dict or Lightning
    checkpoint (e.g. converted reference weights) into the model only;
    returns the meta ({} for the latter)."""
    refuse_directory(path)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "optimizer" in blob:
        state.load_state_dict(blob)
        return dict(blob.get("meta") or {})
    state.model.load_state_dict(load_state_dict_file(path))
    return {}


def save_params(path: str, state_dict: dict) -> str:
    """Write a bare model ``state_dict`` (BN running statistics included,
    no optimizer state), its tensors on the CPU, atomically; under several
    ranks rank 0 writes and every rank waits until it has."""
    path = os.path.abspath(path)
    if mesh.is_main():
        _save_atomic({k: v.detach().cpu() for k, v in state_dict.items()},
                     path)
    mesh.barrier()
    return path


def restore_params(path: str) -> dict:
    """The model state_dict of ``path``: a ``save_params`` file, or any
    file ``load_state_dict_file`` reads."""
    return load_state_dict_file(path)


def extract_backbone(ckpt_path: str, out_path: str) -> str:
    """Save only the backbone's entries of a checkpoint's model state (the
    reference's 'pretrained_weights.pt' warm-start artifact)."""
    sub = {k: v for k, v in load_state_dict_file(ckpt_path).items()
           if k.startswith(_BACKBONE)}
    out_path = os.path.abspath(out_path)
    # the JAX package's orbax save makes the missing parents too
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    _save_atomic(sub, out_path)
    return out_path


def backbone_entries(state_dict: dict) -> dict:
    """The backbone's entries of a state_dict in either layout, under the
    pose models' keys: ``backbone_features_module.*`` as they are, and the
    classifier's ``<stage>.<pos>.*`` as
    ``backbone_features_module.<stage index>.<pos>.*``; the rest (heads,
    deconvs, the classifier's head) is left out."""
    out = {}
    for k, v in state_dict.items():
        stage, _, rest = k.partition(".")
        if k.startswith(_BACKBONE):
            out[k] = v
        elif stage in STAGE_NAMES:
            out[f"{_BACKBONE}{STAGE_NAMES.index(stage)}.{rest}"] = v
    return out


def _overlay(model: nn.Module, src: dict) -> int:
    """Copy the entries of ``src`` whose keys ``model`` has; returns how
    many."""
    own = model.state_dict()
    src = {k: v for k, v in src.items() if k in own}
    own.update(src)
    model.load_state_dict(own)
    return len(src)


def load_backbone(model: nn.Module, path: str) -> int:
    """Overlay the backbone of the torch file ``path`` (a bare state_dict,
    a Lightning checkpoint or a training checkpoint, in either layout of
    ``backbone_entries``) onto ``model``'s; returns the number of tensors
    copied.  Raises if the file holds no backbone."""
    n = _overlay(model, backbone_entries(load_state_dict_file(path)))
    if not n:
        raise ValueError(f"{path} holds no darknet19 backbone weights")
    return n


def load_pretrained(state: TrainState, pretrained_path: str) -> None:
    """Overlay a partial state_dict (or a checkpoint's model state) onto
    the model where the keys match; other keys of either side are left
    alone (strict=False warm start, reference: train_sbp.py:44-46)."""
    _overlay(state.model, load_state_dict_file(pretrained_path))
