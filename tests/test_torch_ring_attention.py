"""The port's ring attention (``opendwm_tpu_torch/ops/ring_attention.py``)
against JAX's ``ring_attention_replicated`` / ``ring_attention_sharded``
(``opendwm_tpu/ops/ring_attention.py``) on the 8-device virtual CPU mesh.

The port runs in spawned gloo ranks (``torch_dist_workers``, no JAX in
them) at world sizes 2 and 4, its ring over the whole world; JAX's at
tp 2 and 4. Forward and dq/dk/dv of a cotangent within 1e-5 in fp32;
both refuse a sequence that does not divide by the ring; the one-process
form (``ring_steps``: n ranks' block steps in one process) equals the
spawned ring bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from opendwm_tpu.ops.ring_attention import (
    ring_attention_replicated as jax_replicated,
)
from opendwm_tpu.ops.ring_attention import (
    ring_attention_sharded as jax_sharded,
)
from opendwm_tpu.parallel import MeshSpec, make_mesh
from opendwm_tpu_torch.ops import ring_attention as ra

import torch_dist_workers as workers

TOL = 1e-5
SHAPE = (2, 24, 2, 8)  # (b, seq, h, d): seq divides by 2 and 4


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _jax(tp: int):
    """JAX's replicated and sharded rings at tp: {kind: [out, dq, dk, dv]}
    for the cotangent ``do`` of the output."""
    q, k, v, do = (jnp.asarray(a) for a in _inputs())
    mesh = make_mesh(MeshSpec(dp=1, fsdp=1, tp=tp), jax.devices()[:tp])

    def replicated(q, k, v):
        return jax.shard_map(
            functools.partial(jax_replicated, axis_name="tp"), mesh=mesh,
            in_specs=(P(), P(), P()), out_specs=P(), check_vma=False)(
                q, k, v)

    def sharded(q, k, v):
        return jax_sharded(q, k, v, mesh, axis="tp")

    def with_grads(fn):
        def run(q, k, v, do):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o, *vjp(do))

        return jax.jit(run)

    return {kind: [np.asarray(a) for a in with_grads(fn)(q, k, v, do)]
            for kind, fn in (("replicated", replicated),
                             ("sharded", sharded))}


@pytest.fixture(scope="module")
def runs():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    jax_ref = {tp: _jax(tp) for tp in (2, 4)}
    port = {n: workers.run_group("ring_case", n, q, k, v, do, n)
            for n in (2, 4)}
    return jax_ref, port


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_matches_jax(runs, n):
    """Every rank holds the whole output and the single-device gradients,
    as JAX's replicated ring gives."""
    jax_ref, port = runs
    for rank in port[n]:
        for got, want in zip(rank["replicated"], jax_ref[n]["replicated"]):
            assert got.shape == want.shape
            assert _scaled(got.numpy(), want) <= TOL


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_jax(runs, n):
    """Each rank's output and gradient slices, put together in ring order,
    equal JAX's sharded ring's global arrays."""
    jax_ref, port = runs
    for i in range(4):
        got = torch.cat([rank["sharded"][i] for rank in port[n]], dim=1)
        assert _scaled(got.numpy(), jax_ref[n]["sharded"][i]) <= TOL


@pytest.mark.parametrize("n", [2, 4])
def test_indivisible_sequence_raises_as_jax(runs, n):
    """23 tokens do not split over the ring: JAX asserts seq % n == 0, the
    port raises a ValueError naming both."""
    _, port = runs
    assert "seq 23, n %d" % n in port[n][0]["indivisible"]
    q = jnp.zeros((1, 23, 2, 8))
    mesh = make_mesh(MeshSpec(dp=1, fsdp=1, tp=n), jax.devices()[:n])
    with pytest.raises(AssertionError):
        jax.shard_map(functools.partial(jax_replicated, axis_name="tp"),
                      mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
                      check_vma=False)(q, q, q)


@pytest.mark.parametrize("n", [2, 4])
def test_one_process_steps_equal_the_spawned_ring(runs, n):
    """``ring_steps`` / ``ring_steps_backward`` over n slices in one process
    give the spawned ring's outputs and gradients bit for bit."""
    _, port = runs
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    qs, ks, vs, dos = (list(t.chunk(n, 1)) for t in (q, k, v, do))
    res = ra.ring_steps(qs, ks, vs)
    outs, lses = [o for o, _ in res], [lse for _, lse in res]
    dq, dk, dv = ra.ring_steps_backward(qs, ks, vs, outs, dos, lses)
    for r, rank in enumerate(port[n]):
        got = rank["sharded"]
        assert torch.equal(got[0], outs[r])
        for a, b in zip(got[1:], (dq[r], dk[r], dv[r])):
            assert torch.equal(a, b)
