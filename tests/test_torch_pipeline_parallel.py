"""The port's GPipe schedule (``opendwm_tpu_torch/parallel/pipeline.py``)
against JAX's ``pipeline_apply`` in the cases of
``tests/test_pipeline_parallel.py``, on the CPU in fp32.

The port runs in spawned gloo ranks (``torch_dist_workers``: no JAX in
them) at world 2 (pp 2) and world 4 (pp 4, and dp 2 x pp 2); JAX's on the
virtual CPU mesh of the same shape. The exact forward, the forward with
conditioning, the gradients of sum(out^2) for the stacked parameters, the
input and the conditioning, the dp composition (the batch sharded over dp
with ``batch_axis``) and a batch that does not divide by the microbatches
(a ValueError in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opendwm_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from opendwm_tpu.parallel.pipeline import (
    stack_stage_params as jax_stack,
)

import torch_dist_workers as workers

TOL = 1e-5


def jax_block(params, h, *conds):
    out = jnp.tanh(h @ params["w"] + params["b"])
    for c in conds:
        out = out + c
    return out


def make_stages(n, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
            for _ in range(n)]


def _arrays(seed, batch, d, cond_scale=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, d)).astype(np.float32)
    if cond_scale is None:
        return x, ()
    return x, ((rng.standard_normal((batch, d)) * cond_scale)
               .astype(np.float32),)


# name: (dp, width, batch, microbatches, seed, conditioned, batch_axis);
# pp = world / dp
CASES = {
    "exact": (1, 16, 24, 8, 0, False, None),
    "conditioned": (1, 8, 16, 4, 3, True, None),
    "dp": (2, 8, 16, 4, 11, True, "dp"),
}


def _case(name, world):
    """(stages, x, conds, microbatches, pp, batch_axis) of a case at
    ``world``: pp = world, or 2 x (world / 2) with dp."""
    dp, d, batch, m, seed, cond, axis = CASES[name]
    pp = world // dp
    stages = make_stages(pp, d, seed)
    x, conds = _arrays(seed + 1, batch, d, 0.05 if cond else None)
    return stages, x, conds, m // dp if dp > 1 else m, pp, axis


def _jax(name, world):
    """JAX's output and gradients of sum(out^2) for the case at ``world``."""
    stages, x, conds, m, pp, axis = _case(name, world)
    devs = np.asarray(jax.devices()[:world])
    if axis:
        mesh = Mesh(devs.reshape(world // pp, pp), ("dp", "pp"))
    else:
        mesh = Mesh(devs.reshape(pp), ("pp",))
    stacked = jax_stack([jax.tree.map(jnp.asarray, s) for s in stages])

    def loss(params, x, *conds):
        out = jax_pipeline(jax_block, params, x, mesh, microbatches=m,
                           conds=conds, batch_axis=axis)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(2 + len(conds))), has_aux=True))(
            stacked, jnp.asarray(x), *(jnp.asarray(c) for c in conds))
    return {"out": np.asarray(out),
            "params": jax.tree.map(np.asarray, grads[0]),
            "x": np.asarray(grads[1]),
            "conds": [np.asarray(g) for g in grads[2:]]}


def _torch_case(name, world):
    stages, x, conds, m, pp, axis = _case(name, world)
    stages = [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages]
    return ("gpipe_case", (stages, torch.from_numpy(x),
                           tuple(torch.from_numpy(c) for c in conds), m, pp,
                           axis, True))


@pytest.fixture(scope="module")
def runs():
    ref, port = {}, {}
    for world in (2, 4):
        cases = {name: _torch_case(name, world) for name in CASES}
        stages, x, _, _, pp, _ = _case("exact", world)
        # 10 rows do not split into 4 microbatches
        cases["indivisible"] = ("gpipe_case", (
            [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages],
            torch.from_numpy(x[:10]), (), 4, pp, None, False))
        port[world] = workers.run_group("run_cases", world, cases)
        ref[world] = {name: _jax(name, world) for name in CASES}
    return ref, port


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(runs, name, world):
    """Every rank holds the whole output (replicated over pp)."""
    ref, port = runs
    for rank in port[world]:
        _close(rank[name]["out"], ref[world][name]["out"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(runs, name, world):
    """Each rank's gradient of its stage's row of the stacked parameters is
    JAX's; the input's and the conditioning's are whole on every rank."""
    ref, port = runs
    want = ref[world][name]
    pp = _case(name, world)[4]
    for r, rank in enumerate(port[world]):
        got = rank[name]
        stage = r % pp
        for key in ("w", "b"):
            _close(got["params"][key][stage], want["params"][key][stage])
        _close(got["x"], want["x"])
        for a, b in zip(got["conds"], want["conds"]):
            _close(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_batch_not_divisible_raises(runs, world):
    _, port = runs
    assert port[world][0]["indivisible"]["error"] == \
        "batch 10 not divisible by 4."
    pp = world
    devs = np.asarray(jax.devices()[:pp])
    stacked = jax_stack([jax.tree.map(jnp.asarray, s)
                         for s in make_stages(pp, 8, 0)])
    with pytest.raises(ValueError):
        jax_pipeline(jax_block, stacked, jnp.ones((10, 8)),
                     Mesh(devs, ("pp",)), microbatches=4)
