"""Port kernels' plain versions vs the JAX package's Pallas kernels.

The Pallas kernels run in interpret mode on the CPU (``pallas_call`` is
patched for the test only). The port's wrappers take their plain version
on CPU tensors; the Hopper kernels themselves are checked on the card
(``tests/test_torch_kernels.py`` and ``chip_smoke.py``).

Tolerance: 1e-5 max abs in fp32 — the same math in another summation
order.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from opendwm_tpu.ops import attention as jax_attention
from opendwm_tpu.ops import flash_tail as jax_flash_tail
from opendwm_tpu.ops import fused_adaln as jax_fused_adaln
from opendwm_tpu_torch import ops
from opendwm_tpu_torch.ops import attention, flash_tail, fused_adaln

TOL = 1e-5


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 .max())


@pytest.mark.parametrize("seq", [150, 168])
def test_flash_tail_plain_matches_pallas(interpret_pallas, seq):
    rng = np.random.default_rng(seq)
    q, k, v = (_randn(rng, 2, seq, 2, 16) for _ in range(3))
    scale = 16 ** -0.5
    ref = jax_flash_tail.tail_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    out = flash_tail.tail_masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    assert out.shape == ref.shape
    assert _max_err(out, ref) <= TOL


@pytest.mark.parametrize("mod_ndim", [2, 3])
def test_adaln_plain_matches_pallas(interpret_pallas, mod_ndim):
    rng = np.random.default_rng(mod_ndim)
    n, l, d = 2, 150, 128
    x = _randn(rng, n, l, d) * 2 + 0.5
    mod_shape = (n, d) if mod_ndim == 2 else (n, 1, d)
    scale, shift = _randn(rng, *mod_shape), _randn(rng, *mod_shape)
    ref = jax_fused_adaln.adaln_modulate(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    out = fused_adaln.adaln_modulate(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift))
    assert out.shape == ref.shape
    assert _max_err(out, ref) <= TOL


@pytest.mark.parametrize("mod_ndim", [2, 3])
def test_residual_adaln_plain_matches_pallas(interpret_pallas, mod_ndim):
    rng = np.random.default_rng(10 + mod_ndim)
    n, l, d = 2, 150, 128
    x, delta = _randn(rng, n, l, d), _randn(rng, n, l, d)
    mod_shape = (n, d) if mod_ndim == 2 else (n, 1, d)
    gate, scale, shift = (_randn(rng, *mod_shape) for _ in range(3))
    ref_x, ref_y = jax_fused_adaln.residual_adaln_modulate(
        *(jnp.asarray(a) for a in (x, delta, gate, scale, shift)))
    out_x, out_y = fused_adaln.residual_adaln_modulate(
        *(torch.from_numpy(a) for a in (x, delta, gate, scale, shift)))
    assert _max_err(out_x, ref_x) <= TOL
    assert _max_err(out_y, ref_y) <= TOL


@pytest.mark.parametrize(
    "seq,kv_heads,bias,causal",
    [
        (6, 2, False, False),    # tiny-sequence form (temporal pointwise)
        (6, 2, True, False),     # tiny form with a relative bias
        (40, 2, False, False),   # plain math
        (40, 1, False, True),    # causal, grouped-query
        (150, 2, False, False),  # tail-masked kernel's shapes
        (150, 2, True, False),   # bias forces plain math
    ],
)
def test_dot_product_attention_matches_jax(seq, kv_heads, bias, causal):
    rng = np.random.default_rng(seq + kv_heads)
    q = _randn(rng, 2, seq, 2, 16)
    k, v = _randn(rng, 2, seq, kv_heads, 16), _randn(rng, 2, seq, kv_heads, 16)
    b = _randn(rng, 1, 2, seq, seq) if bias else None
    ref = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), is_causal=causal)
    out = attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if b is None else torch.from_numpy(b), is_causal=causal)
    assert _max_err(out, ref) <= TOL


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_randn(rng, 1, 130, 2, 8))
    x = torch.from_numpy(_randn(rng, 1, 3, 128))
    m = torch.from_numpy(_randn(rng, 1, 128))
    attention.dot_product_attention(q, q, q)
    fused_adaln.adaln_modulate(x, m, m)
    fused_adaln.residual_adaln_modulate(x, x, m, m, m)
    counts = ops.launch_counts()
    assert counts["flash_tail"] == 0
    assert counts["adaln_modulate"] == counts["residual_adaln_modulate"] == 0


def test_wrappers_refuse_other_devices():
    t = torch.empty(1, 130, 2, 8, device="meta")
    with pytest.raises(ValueError):
        flash_tail.tail_masked_attention(t, t, t, 0.3)
    x = torch.empty(1, 3, 128, device="meta")
    with pytest.raises(ValueError):
        fused_adaln.adaln_modulate(x, x[:, 0], x[:, 0])


def test_flash_tail_supported_matches_jax():
    for shape in [(602, 602, 64), (448, 448, 64), (168, 168, 64),
                  (6, 6, 64), (1100, 1100, 64), (602, 154, 64),
                  (256, 256, 160)]:
        assert flash_tail.supported(*shape) == jax_flash_tail.supported(*shape)


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from opendwm_tpu_torch import config, convert, ops\n"
        "from opendwm_tpu_torch.models import autoencoders, layers, mmdit\n"
        "from opendwm_tpu_torch.pipelines import ctsd\n"
        "from opendwm_tpu_torch.schedulers import FlowMatchEulerScheduler\n"
        "q = torch.randn(1, 130, 2, 8)\n"
        "ops.attention.dot_product_attention(q, q, q)\n"
        "config.create_instance_from_config({'_class_name': "
        "'FlowMatchEulerScheduler', 'shift': 3.0})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'opendwm_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
