"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported): every top-level public name (a function,
class or assigned name not starting with ``_``) of each JAX module has a
counterpart of the same name in the port's module of the same path, or
stands below in ``JAX_SPECIFIC`` with its reason.  This keeps "the port
does what the JAX package does" checked as either package changes."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "pytorch_pose_estimation_tpu")
PORT_PKG = os.path.join(ROOT, "pytorch_pose_estimation_tpu_torch")

_MESH = ("jax.sharding on a device mesh; the port's data parallelism is "
         "torch.distributed (parallel/mesh.py: world_size, local_rows, "
         "all_reduce_sum)")
JAX_SPECIFIC = {
    ("models/layers.py", "Dtype"):
        "flax's type alias for a jnp dtype; the port takes torch.dtype",
    ("models/torch_import.py", "import_torch_checkpoint"):
        "maps a torch checkpoint into flax variables; the port loads torch "
        "files as they are (models/convert.py: load_state_dict_file)",
    ("models/torch_import.py", "import_torch_state_dict"):
        "as import_torch_checkpoint",
    ("ops/pallas/decode.py", "decode_sbp_pallas"):
        "Pallas TPU kernel K2; its port is csrc/decode.cu through "
        "ops/kernels.py: decode_sbp_cuda",
    ("ops/pallas/heatmap.py", "sbp_heatmaps_pallas"):
        "Pallas TPU kernel K1; its port is csrc/heatmap.cu through "
        "ops/kernels.py: sbp_heatmaps_cuda",
    ("parallel/mesh.py", "DATA_AXIS"): _MESH,
    ("parallel/mesh.py", "batch_sharding"): _MESH,
    ("parallel/mesh.py", "make_mesh"): _MESH,
    ("parallel/mesh.py", "replicated_sharding"): _MESH,
    ("parallel/mesh.py", "shard_host_batch"): _MESH,
    ("parallel/mesh.py", "spatial_sharding"):
        "GSPMD height sharding; the port's is parallel/spatial.py (halo "
        "exchange over torch.distributed)",
    ("train/state.py", "create_train_state"):
        "builds a flax TrainState from an init; the port's TrainState holds "
        "the torch model and optimizer the Trainer builds",
}


def _public_names(path: str) -> set:
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _modules(pkg: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                out[os.path.relpath(path, pkg)] = _public_names(path)
    return out


JAX_MODULES = _modules(JAX_PKG)


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_every_public_name_has_a_port_counterpart(module):
    port = os.path.join(PORT_PKG, module)
    port_names = _public_names(port) if os.path.exists(port) else set()
    missing = sorted(n for n in JAX_MODULES[module] - port_names
                     if (module, n) not in JAX_SPECIFIC)
    assert not missing, f"{module}: no port counterpart for {missing}"


def test_the_jax_specific_list_is_current():
    """Each listed name still exists in the JAX package and still lacks a
    port counterpart, and each reason names what the port does instead."""
    port = _modules(PORT_PKG)
    for (module, name), reason in JAX_SPECIFIC.items():
        assert name in JAX_MODULES.get(module, ()), (module, name)
        assert name not in port.get(module, ()), (module, name)
        assert len(reason) > 20, (module, name)
