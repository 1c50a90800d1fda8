"""Height-sharded inference (``parallel.spatial``) on the CPU: gloo ranks
spawned by ``parallel.launch`` (2 and 4, once each, in module fixtures;
the rank bodies in the jax-free ``tests/_torch_spatial_worker.py``).

* tests/test_parallel.py's ``SpatialStack`` (conv, pool, conv, deconv,
  1x1 conv), its flax init converted, against the JAX package's own
  H-sharded forward (``spatial_sharding``'s ``P(None, 'data')``) on a 2-
  and a 4-device mesh of the conftest's virtual CPU devices;
* the full-width fp32 SBP and SPM, weights from a seeded init with the BN
  running statistics calibrated on 16 seeded images so that the logits
  stay O(1), at 64 rows on 2 ranks and 128 on 4, against the port's
  one-process forward and the flax forward of the same weights (the JAX
  package's importer; atol 1e-4, test_torch_port_models.py's);
* the refusals (train mode, a height that does not divide), and with one
  rank the normal forward bit for bit.

Tolerance: rtol 2e-4 and atol 2e-5, tests/test_parallel.py's for
``spatial_sharding``.  The full-width comparisons with the one-process
forward run torch's native CPU convolutions on both sides (the ranks and
the reference): oneDNN picks its algorithm by shape, so a block's rows
and the whole image take different sums, and the SBP's logits (O(1))
then differ by 2-5e-5, as much as one ulp of input noise moves the
one-process logits.  With native convolutions the gap is 3-7e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_pose_estimation_tpu.models.layers import (ConvBnRelu as
                                                       FlaxConvBnRelu,
                                                       DeconvBnRelu as
                                                       FlaxDeconvBnRelu)
from pytorch_pose_estimation_tpu.models import SBP as JaxSBP
from pytorch_pose_estimation_tpu.models import SPM as JaxSPM
from pytorch_pose_estimation_tpu.models.torch_import import \
    import_torch_state_dict
from pytorch_pose_estimation_tpu.parallel import (make_mesh,
                                                  replicated_sharding)
from pytorch_pose_estimation_tpu_torch import parallel
from pytorch_pose_estimation_tpu_torch.models import lecun_normal_

import _torch_spatial_worker as W

RTOL, ATOL = 2e-4, 2e-5
FLAX_ATOL = 1e-4  # test_torch_port_models.py's, port against flax
ROWS = {2: 64, 4: 128}  # the global height on each world
WIDTH = 64


class SpatialStack(fnn.Module):
    """tests/test_parallel.py:104-111."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = FlaxConvBnRelu(8, 3)(x, train)
        x = fnn.max_pool(x, (2, 2), strides=(2, 2))
        x = FlaxConvBnRelu(16, 3)(x, train)
        x = FlaxDeconvBnRelu(8)(x, train)
        return FlaxConvBnRelu(4, 1)(x, train)


def _stack_to_port(variables) -> dict:
    """The flax SpatialStack's variables -> the port Sequential's
    state_dict (kernels by the permutation (3, 2, 0, 1))."""
    out = {}
    for flax_name, pos, conv, bn in (("ConvBnAct_0", 0, "conv", "bn"),
                                     ("ConvBnAct_1", 2, "conv", "bn"),
                                     ("DeconvBnRelu_0", 3, "0", "1"),
                                     ("ConvBnAct_2", 4, "conv", "bn")):
        p = variables["params"][flax_name]
        s = variables["batch_stats"][flax_name]["bn"]
        kernel = p["deconv" if conv == "0" else "conv"]["kernel"]
        out[f"{pos}.{conv}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(kernel), (3, 2, 0, 1))))
        for src, dst in (("scale", "weight"), ("bias", "bias")):
            out[f"{pos}.{bn}.{dst}"] = torch.from_numpy(np.array(
                p["bn"][src]))
        for src, dst in (("mean", "running_mean"), ("var", "running_var")):
            out[f"{pos}.{bn}.{dst}"] = torch.from_numpy(np.array(s[src]))
        out[f"{pos}.{bn}.num_batches_tracked"] = torch.tensor(0)
    return out


def _calibrated(name: str, seed: int) -> torch.nn.Module:
    """A seeded lecun init whose BN running statistics are the batch
    statistics of a seeded batch and whose head is scaled so that the
    logits lie within +-1 there (``calibrated_jax_variables``' recipe,
    started from the port's init)."""
    model = lecun_normal_(W.BUILD[name](), torch.Generator().manual_seed(
        seed))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    x = torch.from_numpy(np.random.RandomState(seed).rand(
        16, 3, 64, WIDTH).astype(np.float32))
    with torch.no_grad():
        model.train()(x)
        getattr(model, f"{name}_head")[0].weight /= \
            model.eval()(x).abs().max()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 0.1
    return model.eval()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    stack_vars = jax.tree_util.tree_map(np.asarray, SpatialStack().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    models = {"stack": W.spatial_stack().eval(),
              "sbp": _calibrated("sbp", 1), "spm": _calibrated("spm", 2)}
    models["stack"].load_state_dict(_stack_to_port(stack_vars))
    paths = {}
    for name, model in models.items():
        paths[name] = str(root / f"{name}.pt")
        torch.save(model.state_dict(), paths[name])
    rng = np.random.RandomState(3)
    inputs = {world: {name: rng.rand(1, 3, ROWS[world], WIDTH).astype(
        np.float32) for name in models} for world in ROWS}
    # the JAX test's input: rand(1, 64, 64, 3) from seed 0
    for world in ROWS:
        inputs[world]["stack"] = np.random.RandomState(0).rand(
            1, 64, 64, 3).astype(np.float32).transpose(0, 3, 1, 2)
    return {"paths": paths, "models": models, "inputs": inputs,
            "stack_vars": stack_vars}


def _launch(setup, world):
    spec = {"models": setup["paths"], "inputs": setup["inputs"][world]}
    return parallel.launch(W.rank_main, ["cpu"] * world, "gloo",
                           args=(spec,))


@pytest.fixture(scope="module")
def two(setup):
    return _launch(setup, 2)


@pytest.fixture(scope="module")
def four(setup):
    return _launch(setup, 4)


def _ranks(request, world):
    return request.getfixturevalue({2: "two", 4: "four"}[world])


def _gathered(ranks, name):
    """The gathered output, the same on every rank, and each rank's rows
    in it."""
    g = ranks[0]["out"][name]["gathered"]
    h = ranks[0]["out"][name]["rows"].shape[2]
    for r in ranks:
        assert torch.equal(r["out"][name]["gathered"], g)
        rows = r["out"][name]["rows"]
        assert torch.equal(g[:, :, r["rank"] * h:(r["rank"] + 1) * h], rows)
    return g.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_stack_matches_jax_sharded_forward(setup, request, world):
    ranks = _ranks(request, world)
    x = setup["inputs"][world]["stack"].transpose(0, 2, 3, 1)
    model, variables = SpatialStack(), setup["stack_vars"]
    mesh = make_mesh(jax.devices()[:world])
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "data")))
    assert {s.data.shape for s in xs.addressable_shards} == {
        (1, 64 // world, 64, 3)}
    vs = jax.device_put(variables, replicated_sharding(mesh))
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x))(vs, xs))
    got = _gathered(ranks, "stack").transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 0.1
    assert ranks[0]["out"]["stack"]["stats"]["exchanges"] == 3


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["sbp", "spm"])
def test_posenet_rows_match_one_process_and_flax(setup, request, name,
                                                 world):
    ranks = _ranks(request, world)
    got = _gathered(ranks, name)
    x = setup["inputs"][world][name]
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        one = setup["models"][name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)
    jax_model = (JaxSPM if name == "spm" else JaxSBP)(num_keypoints=W.K)
    variables = import_torch_state_dict(setup["models"][name].state_dict())
    with jax.default_matmul_precision("highest"):
        flax = np.asarray(jax_model.apply(variables, jnp.asarray(
            x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, flax, rtol=0, atol=FLAX_ATOL)
    assert 0.1 < np.abs(one).max() <= 5  # O(1) logits
    stats = ranks[0]["out"][name]["stats"]
    assert stats["exchanges"] == 15  # 12 3x3 convs and 3 deconvs


@pytest.mark.parametrize("world", [2, 4])
def test_several_ranks_refuse_train_mode_and_heights(request, world):
    for r in _ranks(request, world):
        assert "eval mode" in r["errors"]["train"]
        assert "not a multiple of" in r["errors"]["height"]


def test_one_rank_is_the_normal_forward_and_refuses(setup):
    """No process group: ``spatial_forward`` is the model's forward bit
    for bit, ``spatial_rows`` and ``gather_spatial`` the identity; train
    mode and heights that do not divide raise."""
    assert not torch.distributed.is_initialized()
    x = torch.from_numpy(setup["inputs"][2]["sbp"])
    with torch.no_grad():
        for name in ("stack", "sbp", "spm"):
            model = setup["models"][name]
            assert torch.equal(parallel.spatial_forward(
                model, parallel.spatial_rows(x)), model(x))
    assert parallel.gather_spatial(x) is x
    sbp, stack = setup["models"]["sbp"], setup["models"]["stack"]
    with pytest.raises(ValueError, match="not a multiple of 1 ranks x 32"):
        parallel.spatial_forward(sbp, x[:, :, :48])
    with pytest.raises(ValueError, match="not a multiple of 1 ranks x 2"):
        parallel.spatial_forward(stack, x[:, :, :63])
    with pytest.raises(ValueError, match="eval mode"):
        parallel.spatial_forward(stack.train(), x)
    stack.eval()
    with pytest.raises(ValueError, match="not divisible"):
        parallel.spatial_rows(x[:, :, :63], 0, 2)
