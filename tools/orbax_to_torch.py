"""Convert the JAX package's orbax checkpoints into the PyTorch port's torch
files.  Run it where JAX runs; the port itself never reads orbax.

    python tools/orbax_to_torch.py --cfg configs/sbp_coco.yaml \\
        --src saved/<model>/version_0/checkpoints/last --out port/last

What ``--src`` holds decides what is written to ``--out``:

* a training checkpoint (``train/checkpoint.py``'s ``CheckpointManager``,
  ``save_checkpoint``; ``train_classifier.py``'s): the port's training
  checkpoint ``{"step", "model", "optimizer", "meta"}`` with its
  ``<out>.meta.json`` sidecar (the source's sidecar, else ``{"step"}``),
  which ``--resume`` and ``--ckpt`` read.  The optimizer state is optax's,
  mapped onto the port's optimizer built from the same ``--cfg``;
* a params-only tree (``save_params``, ``import_torch_checkpoint.py``): a
  bare state_dict, which ``load_model`` and the ``test_*`` and
  ``inference_*`` modules' ``--ckpt`` read;
* a backbone-only tree (``saving_weights.py``'s ``extract_backbone``): the
  ``backbone_features_module.*`` entries, which ``model_pretrained`` and
  ``backbone_pretrained`` read;
* a directory of checkpoints (a run's ``checkpoints/``): each of them,
  under its own name with its sidecar, into the directory ``--out``, so
  that ``--resume auto`` (on ``<save_dir>/<model>/version_N/checkpoints``)
  and ``--ckpt .../best`` work on the copy.

The model comes from ``--cfg``: the darknet19 classifier for its config,
SPM where ``input_size`` is one number, else SBP (PIS is SBP with its
config's keypoints); a checkpoint whose tree does not fit that model is
refused.  A training checkpoint is restored
with the JAX package's ``restore_checkpoint`` into a template state built
from ``--cfg`` as the JAX entry points build it, so that optax's state
types survive; the other trees with ``restore_params``.

A JAX checkpoint holds no torch generator states: a fit resumed from a
converted checkpoint starts its augmentation stream again, as one resumed
from a port checkpoint without the ``rng`` key does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

# runnable as `python tools/orbax_to_torch.py` (the packages live at the
# repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from pytorch_pose_estimation_tpu.config import get_configs  # noqa: E402
from pytorch_pose_estimation_tpu.models import darknet19  # noqa: E402
from pytorch_pose_estimation_tpu.optim import (  # noqa: E402
    build_optimizer_from_cfg as jax_build_optimizer)
from pytorch_pose_estimation_tpu.train.checkpoint import (  # noqa: E402
    restore_checkpoint, restore_params)
from pytorch_pose_estimation_tpu.train.state import (  # noqa: E402
    create_train_state)
from pytorch_pose_estimation_tpu.train.trainer import (  # noqa: E402
    apply_precision_config, build_model as jax_build_model)
from pytorch_pose_estimation_tpu_torch.models import (  # noqa: E402
    from_jax_opt_state, from_jax_variables)
from pytorch_pose_estimation_tpu_torch.models.convert import (  # noqa: E402
    MOMENTS)
from pytorch_pose_estimation_tpu_torch.optim import (  # noqa: E402
    build_optimizer_from_cfg)
from pytorch_pose_estimation_tpu_torch.train import (  # noqa: E402
    TrainState, build_model, save_checkpoint)
from pytorch_pose_estimation_tpu_torch.train_classifier import (  # noqa: E402
    build_classifier)

_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def model_kind(cfg: dict) -> str:
    """The model that ``cfg`` trains: 'classifier', 'spm' or 'sbp'."""
    if cfg.get("model") == "darknet19":
        return "classifier"
    return "spm" if isinstance(cfg["input_size"], int) else "sbp"


def is_orbax_dir(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f)) for f in _ORBAX_FILES)


def tree_metadata(path: str) -> dict:
    """The saved tree's structure (leaves are orbax's array metadata)."""
    meta = ocp.StandardCheckpointer().metadata(os.path.abspath(path))
    meta = getattr(meta, "item_metadata", meta)
    return getattr(meta, "tree", meta)


def _numpy(tree):
    """A restored tree as nested dicts of numpy arrays; optax's
    ``MaskedNode`` (a frozen parameter's place) is left out."""
    if isinstance(tree, optax.MaskedNode):
        return None
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {k: _numpy(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None and
                not (isinstance(v, dict) and not v)}
    return np.asarray(tree)


def flatten_opt_state(opt_state) -> dict:
    """optax's state of a chain (possibly inside ``multi_transform``'s
    masks, as ``freeze`` builds it) -> ``{'count': n, field: params-shaped
    numpy tree}`` for each moment field of ``MOMENTS`` it holds.  Every
    count of the chain (the schedule's, adam's) must agree."""
    out, counts = {}, set()

    def walk(node):
        if isinstance(node, optax.MaskedNode) or node is None:
            return
        fields = getattr(node, "_fields", None)
        if fields is not None:  # an optax state NamedTuple
            for name in fields:
                value = getattr(node, name)
                if name == "count":
                    counts.add(int(np.asarray(value)))
                elif name in MOMENTS:
                    if name in out:
                        raise ValueError(f"two {name!r} states in the chain")
                    out[name] = _numpy(value)
                else:
                    walk(value)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif isinstance(node, dict) or hasattr(node, "items"):
            for v in node.values():
                walk(v)
        else:
            raise ValueError(f"unexpected optimizer state node {node!r}")

    walk(opt_state)
    if len(counts) != 1:
        raise ValueError(f"the chain's counts disagree or are missing: "
                         f"{sorted(counts)}")
    out["count"] = counts.pop()
    return out


def _num_classes(cfg: dict, params_meta: dict) -> int:
    n = int(params_meta["classifier"]["conv"]["kernel"].shape[-1])
    if cfg.get("num_classes") and int(cfg["num_classes"]) != n:
        raise ValueError(f"the checkpoint's classifier has {n} classes, the "
                         f"config {cfg['num_classes']}")
    return n


def jax_template(cfg: dict, kind: str, params_meta: dict):
    """The JAX TrainState that the entry points build from ``cfg``."""
    optimizer, _ = jax_build_optimizer(cfg)
    seed = jax.random.PRNGKey(cfg.get("seed", 0))
    if kind == "classifier":
        precision = apply_precision_config(cfg)
        dtype = jax.numpy.bfloat16 if precision == "bf16" else \
            jax.numpy.float32
        model = darknet19(num_classes=_num_classes(cfg, params_meta),
                          dtype=dtype)
        size = int(cfg["input_size"])
        return create_train_state(model, optimizer, (1, size, size, 3),
                                  rng=seed)
    model = jax_build_model(cfg, "spm" if kind == "spm" else "sbp")
    size = cfg["input_size"]
    h, w = (size, size) if kind == "spm" else size
    return create_train_state(model, optimizer, (1, int(h), int(w), 3),
                              rng=seed)


def port_state(cfg: dict, kind: str, params_meta: dict) -> TrainState:
    """The port's model and optimizer built from the same ``cfg``, on the
    CPU."""
    if kind == "classifier":
        model = build_classifier(cfg, _num_classes(cfg, params_meta))
    else:
        model = build_model(cfg, kind)
    optimizer, schedule = build_optimizer_from_cfg(cfg, model)
    return TrainState(model, optimizer, schedule)


def _read_meta(src: str) -> dict:
    try:
        with open(src.rstrip("/") + ".meta.json") as f:
            return json.load(f)
    except OSError:
        return {}


def _fitted(src: str, sd: dict, model: torch.nn.Module) -> dict:
    """``sd``, raising unless each of its entries is one of ``model``'s,
    of the same shape."""
    want = model.state_dict()
    bad = [f"{k} {tuple(v.shape)}" + (f" (the model's {tuple(want[k].shape)})"
                                       if k in want else "")
           for k, v in sd.items()
           if k not in want or want[k].shape != v.shape]
    if bad:
        raise ValueError(f"{src} does not fit the model that its --cfg "
                         f"builds: {', '.join(bad[:3])}"
                         f"{' ...' if len(bad) > 3 else ''}")
    return sd


def convert_one(cfg: dict, src: str, out: str) -> str:
    """One orbax checkpoint ``src`` -> the torch file ``out``; returns
    what it was ('train', 'params' or 'backbone')."""
    tree = tree_metadata(src)
    params_meta = tree["params"]
    kind = model_kind(cfg)
    if ("stem" in params_meta) != (kind == "classifier"):
        held = "a darknet19 classifier" if "stem" in params_meta else \
            "a pose model"
        raise ValueError(f"{src} holds {held}, and its --cfg builds "
                         f"{kind!r}: give the config it was trained with")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    if "opt_state" in tree:
        jstate = restore_checkpoint(src, jax_template(cfg, kind,
                                                      params_meta))
        variables = {"params": _numpy(jstate.params),
                     "batch_stats": _numpy(jstate.batch_stats)}
        flat = flatten_opt_state(jstate.opt_state)
        step = int(np.asarray(jstate.step))
        if flat["count"] != step:
            raise ValueError(f"{src}: step {step}, optimizer count "
                             f"{flat['count']}")
        state = port_state(cfg, kind, params_meta)
        state.load_state_dict({
            "step": step,
            "model": _fitted(src, from_jax_variables(variables, kind),
                             state.model),
            "optimizer": from_jax_opt_state(flat, state.model,
                                            state.optimizer, kind)})
        meta = _read_meta(src) or {"step": step}
        save_checkpoint(out, state, meta)
        return "train"
    variables = {k: _numpy(v) for k, v in restore_params(src).items()}
    what = "backbone" if set(variables["params"]) == {"backbone"} \
        else "params"
    model = port_state(cfg, kind, params_meta).model
    torch.save(_fitted(src, from_jax_variables(variables, kind), model), out)
    return what


def convert(cfg: dict, src: str, out: str) -> dict:
    """``src``, one orbax checkpoint or a directory of them, -> ``out``
    (a file, or a directory of files); returns {output path: what}."""
    if is_orbax_dir(src):
        return {os.path.abspath(out): convert_one(cfg, src, out)}
    if not os.path.isdir(src):
        raise ValueError(f"{src} is not an orbax checkpoint or a directory "
                         f"of them")
    names = sorted(n for n in os.listdir(src)
                   if is_orbax_dir(os.path.join(src, n)))
    if not names:
        raise ValueError(f"{src} holds no orbax checkpoint")
    os.makedirs(out, exist_ok=True)
    done = {}
    for name in names:
        path = os.path.join(out, name)
        done[path] = convert_one(cfg, os.path.join(src, name), path)
        sidecar = os.path.join(src, name) + ".meta.json"
        if os.path.exists(sidecar):
            shutil.copyfile(sidecar, path + ".meta.json")
    return done


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="A converted training checkpoint holds no torch generator "
               "states: a fit resumed from it starts its augmentation "
               "stream again.",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cfg", required=True,
                        help="the YAML the checkpoint was trained with")
    parser.add_argument("--src", required=True,
                        help="an orbax checkpoint directory, or a "
                             "directory of them (a run's checkpoints/)")
    parser.add_argument("--out", required=True,
                        help="the torch file (or directory) to write")
    args = parser.parse_args(argv)
    # restoring and mapping are host work: an accelerator would only add
    # the copies back to the host
    jax.config.update("jax_platforms", "cpu")
    done = convert(get_configs(args.cfg), args.src, args.out)
    for path, what in done.items():
        print(f"{what}: {path}")
    return done


if __name__ == "__main__":
    main()
