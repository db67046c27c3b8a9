"""The port's device meshes and sharding rules (``opendwm_tpu_torch/
parallel/mesh.py``, ``sharding.py``) against the JAX package's.

``MeshSpec.resolve`` and the policy presets give JAX's shapes and errors;
the dimension each parameter is sharded on is the one JAX's
``PartitionSpec`` names for the same shape (ties, sizes below 2^16 and
the ``tp`` rule included); over 4 spawned gloo ranks (no JAX in them) the
meshes are ``DeviceMesh``es of those shapes and axis names, and each data
rank's ``shard_batch`` slice is JAX's shard of the batch.
"""

import jax
import numpy as np
import pytest
import torch

from opendwm_tpu.parallel import mesh as jmesh
from opendwm_tpu.parallel import sharding as jsharding
from opendwm_tpu_torch import config
from opendwm_tpu_torch.parallel import mesh as tmesh
from opendwm_tpu_torch.parallel import sharding as tsharding

import torch_dist_workers as workers

SPECS = [
    (dict(), 8), (dict(dp=2, fsdp=-1), 8), (dict(dp=-1, fsdp=2, tp=2), 8),
    (dict(dp=2, fsdp=2, tp=2), 8), (dict(fsdp=-1, pp=4), 8),
    (dict(dp=1, fsdp=1, tp=1, pp=1), 1), (dict(dp=-1, fsdp=-1), 8),
    (dict(dp=3, fsdp=-1), 8), (dict(dp=2, fsdp=2), 8), (dict(pp=3), 6),
]
# ties, sizes below 2^16, nothing divisible, flax-like and torch-like
SHAPES = {
    "tie": (512, 512), "first_larger": (2048, 64), "last_larger": (64, 2048),
    "small": (128, 128), "bias": (1536,), "odd": (257, 255),
    "conv": (3, 3, 320, 640), "big_bias": (98304,), "three": (96, 1024, 4),
    "scalar_like": (1,), "just_below": (255, 256), "just_at": (256, 256),
}


def _resolve(resolve, n):
    try:
        return resolve(n)
    except ValueError as err:
        return f"ValueError: {err}"


@pytest.mark.parametrize("kw,n", SPECS)
def test_mesh_spec_resolve_matches_jax(kw, n):
    assert _resolve(tmesh.MeshSpec(**kw).resolve, n) == \
        _resolve(jmesh.MeshSpec(**kw).resolve, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("policy", ["ddp", "fsdp", "hsdp"])
def test_policy_presets_match_jax(policy, n):
    want = jmesh.mesh_for_policy(policy, jax.devices()[:n])
    spec = tmesh.policy_spec(policy, n)
    assert spec.resolve(n) == tuple(want.shape.values())
    with pytest.raises(ValueError, match="Unknown mesh policy"):
        tmesh.policy_spec("zero3", n)


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_shard_dimension_matches_jax(size):
    for shape in SHAPES.values():
        for min_size in (jsharding.MIN_SHARD_SIZE, 1024):
            spec = jsharding._fsdp_spec(shape, size, min_size)
            want = next((i for i, a in enumerate(spec) if a is not None),
                        None)
            assert tsharding.fsdp_dim(shape, size, min_size) == want, shape
        spec = jsharding._tp_spec(shape, size)
        want = next((i for i, a in enumerate(spec) if a is not None), None)
        assert tsharding.tp_dim(shape, size) == want, shape


def test_one_process_mesh_is_the_one_device():
    """Without a process group the mesh is the one device: every axis of
    size 1, no groups, the model left as it is and the batch whole."""
    mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=1, fsdp=-1))
    assert isinstance(mesh, tmesh.SingleDeviceMesh)
    assert mesh.mesh_dim_names == ("dp", "fsdp", "tp")
    assert tmesh.axis_size(mesh, "fsdp") == 1
    assert tmesh.axis_group(mesh, "tp") is None
    assert tmesh.make_mesh(tmesh.MeshSpec(fsdp=1, pp=-1)).mesh_dim_names == \
        ("dp", "fsdp", "tp", "pp")
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        tmesh.make_mesh(tmesh.MeshSpec(pp=2, fsdp=1))
    model = torch.nn.Linear(4, 4)
    assert tsharding.shard_model(model, mesh) is model
    assert not hasattr(model.weight, "placements")
    batch = {"x": torch.zeros(4, 2)}
    assert tsharding.shard_batch(batch, mesh) is batch
    # the registry resolves the reference's mesh call to MeshSpec
    spec = config.create_instance_from_config({
        "_class_name": "torch.distributed.device_mesh.init_device_mesh",
        "dp": 2, "fsdp": 4})
    assert spec == tmesh.MeshSpec(dp=2, fsdp=4)


@pytest.fixture(scope="module")
def four():
    batch = {"latents": torch.arange(8.0).reshape(8, 1),
             "nested": {"ids": torch.arange(4)},
             "odd": torch.arange(6.0), "scalar": torch.tensor(3.0),
             "array": np.arange(12).reshape(4, 3), "text": "prompt"}
    return workers.run_group("mesh_case", 4, dict(SHAPES), batch), batch


def test_device_meshes_over_four_ranks(four):
    ranks, _ = four
    axes = ("dp", "fsdp", "tp")
    want = {"default": ((1, 4, 1), axes), "dp2fsdp2": ((2, 2, 1), axes),
            "tp4": ((1, 1, 4), axes), "pp2": ((1, 2, 1, 2), axes + ("pp",)),
            "ddp": ((4, 1, 1), axes), "fsdp": ((1, 4, 1), axes),
            "hsdp": ((1, 4, 1), axes)}
    for rank in ranks:
        assert rank["meshes"] == want
    for policy, (shape, _) in want.items():
        if policy in ("ddp", "fsdp", "hsdp"):
            assert shape == tuple(jmesh.mesh_for_policy(
                policy, jax.devices()[:4]).shape.values())


def test_param_shardings_match_jax_on_a_mesh(four):
    ranks, _ = four
    mesh = jmesh.make_mesh(jmesh.MeshSpec(dp=2, fsdp=2), jax.devices()[:4])
    tp_mesh = jmesh.make_mesh(jmesh.MeshSpec(dp=1, fsdp=1, tp=4),
                              jax.devices()[:4])
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    for policy in ("ddp", "fsdp", "hsdp", "tp"):
        want = jsharding.param_shardings(params, tp_mesh if policy == "tp"
                                         else mesh, policy)
        for name, sharding in want.items():
            dim = next((i for i, a in enumerate(sharding.spec)
                        if a is not None), None)
            for rank in ranks:
                assert rank["shardings"][policy][name] == dim, (policy, name)


def test_shard_batch_slices_match_jax(four):
    """Data rank r = dp_rank * fsdp + fsdp_rank takes rows [r n / 4, (r + 1)
    n / 4) of each leaf whose leading axis divides by 4, as JAX's sharding
    over ("dp", "fsdp") lays them out; the rest stays whole."""
    ranks, batch = four
    mesh = jmesh.make_mesh(jmesh.MeshSpec(dp=2, fsdp=2), jax.devices()[:4])
    sharded = jsharding.shard_batch(
        {"latents": batch["latents"].numpy()}, mesh)["latents"]
    shards = {s.device.id: np.asarray(s.data)
              for s in sharded.addressable_shards}
    order = [d.id for d in mesh.devices.reshape(-1)]
    for r, rank in enumerate(ranks):
        assert rank["data_rank"] == (r, r // 2, r % 2)
        got = rank["batch"]
        np.testing.assert_array_equal(got["latents"].numpy(),
                                      shards[order[r]])
        assert torch.equal(got["nested"]["ids"], torch.tensor([r]))
        assert torch.equal(got["odd"], batch["odd"])
        assert torch.equal(got["scalar"], batch["scalar"])
        np.testing.assert_array_equal(got["array"], batch["array"][r:r + 1])
        assert got["text"] == "prompt"
