"""Port kernels' plain versions vs the JAX package's Pallas kernels.

K7 (``ops/flash_attention.py``) is held against the JAX dispatcher forced
to its stock Pallas flash attention (``backend="pallas"``).

The Pallas kernels run in interpret mode on the CPU (``pallas_call`` is
patched for the test only). The port's wrappers take their plain version
on CPU tensors; the Hopper kernels themselves are checked on the card
(``tests/test_torch_kernels.py`` and ``chip_smoke.py``).

Tolerance: 1e-5 max abs in fp32 — the same math in another summation
order (scaled by max(1, |reference|) for gradients). Gradients of the port
(autograd through its Functions) are held against ``jax.vjp`` of the JAX
package's ``custom_vjp`` functions, whose backward is the Pallas K2 kernel
(attention) or the vjp of the jnp reference (AdaLN).
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from opendwm_tpu.ops import attention as jax_attention
from opendwm_tpu.ops import flash_tail as jax_flash_tail
from opendwm_tpu.ops import fused_adaln as jax_fused_adaln
from opendwm_tpu_torch import ops
from opendwm_tpu_torch.ops import (
    attention,
    flash_attention,
    flash_tail,
    fused_adaln,
)

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


def _scaled_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _port_vjp(fn, inputs, cotangents):
    """Outputs and input gradients of ``fn`` under torch autograd."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(
        outs, leaves, [torch.from_numpy(c) for c in cotangents])
    return [o.detach() for o in outs], grads


def _jax_vjp(fn, inputs, cotangents):
    outs, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    ct = tuple(jnp.asarray(c) for c in cotangents)
    grads = vjp(ct if isinstance(outs, tuple) else ct[0])
    return outs, grads


@pytest.mark.parametrize("seq", [130, 200])
def test_flash_tail_backward_plain_matches_pallas(interpret_pallas, seq):
    """The plain K2 against the Pallas ``_backward`` (interpret mode)."""
    rng = np.random.default_rng(100 + seq)
    q, k, v, do = (_randn(rng, 2, seq, 2, 16) for _ in range(4))
    scale = 16 ** -0.5
    ref = jax_flash_tail._backward(*(jnp.asarray(a) for a in (q, k, v, do)),
                                   scale)
    out = flash_tail.tail_masked_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)), scale)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert _max_err(a, b) <= TOL


def test_flash_tail_autograd_matches_jax_vjp(interpret_pallas):
    """Autograd of the port's attention (its Function: plain forward and
    backward on the CPU) against ``jax.vjp`` (Pallas K1 and K2)."""
    rng = np.random.default_rng(7)
    q, k, v, ct = (_randn(rng, 2, 150, 2, 16) for _ in range(4))
    scale = 0.3
    (out,), grads = _port_vjp(
        lambda *a: flash_tail.tail_masked_attention(*a, scale), (q, k, v),
        (ct,))
    ref_out, ref_grads = _jax_vjp(
        lambda *a: jax_flash_tail.tail_masked_attention(*a, scale),
        (q, k, v), (ct,))
    assert _max_err(out, ref_out) <= TOL
    for a, b in zip(grads, ref_grads):
        assert _scaled_err(a, b) <= TOL


@pytest.mark.parametrize("residual", [False, True])
def test_adaln_gradients_match_jax_vjp(interpret_pallas, residual):
    """Gradients of the fused AdaLN (plain on the CPU, as the kernels'
    backward is autograd of the plain version) against ``jax.vjp`` of the
    Pallas functions, fp32. In bf16 the residual form differs by design:
    the JAX backward differentiates ``_res_reference``, which rounds
    ``x'`` to bf16 before the LayerNorm; the port normalises the fp32 sum
    as the kernel does (see ``test_residual_adaln_bf16_rounding``)."""
    rng = np.random.default_rng(20 + residual)
    n, l, d = 2, 150, 128
    x, delta = _randn(rng, n, l, d) * 2 + 0.5, _randn(rng, n, l, d)
    # (n, 1, d): the JAX backward's reference broadcasts only that form
    gate, scale, shift = (_randn(rng, n, 1, d) for _ in range(3))
    if residual:
        inputs = (x, delta, gate, scale, shift)
        cts = (_randn(rng, n, l, d), _randn(rng, n, l, d))
        port_fn = fused_adaln.residual_adaln_modulate
        jax_fn = jax_fused_adaln.residual_adaln_modulate
    else:
        inputs = (x, scale, shift)
        cts = (_randn(rng, n, l, d),)
        port_fn = fused_adaln.adaln_modulate
        jax_fn = jax_fused_adaln.adaln_modulate
    outs, grads = _port_vjp(port_fn, inputs, cts)
    ref_outs, ref_grads = _jax_vjp(jax_fn, inputs, cts)
    ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
    for a, b in zip(outs, ref_outs):
        assert _max_err(a, b) <= TOL
    for a, b in zip(grads, ref_grads):
        assert a.shape == b.shape
        assert _scaled_err(a, b) <= TOL


def test_residual_adaln_bf16_rounding(interpret_pallas):
    """The one place where the port and the JAX package round differently,
    pinned so that it is seen: in bf16 both return the same ``x'`` (the
    fp32 sum rounded once), but the JAX forward's LayerNorm reads the fp32
    sum (``_res_kernel``) while its backward differentiates the rounded one
    (``_res_reference``); the port's plain version, like its kernel, uses
    the fp32 sum in both. The gradients then differ by up to a few bf16
    ulps (scaled 9e-3 to 3.1e-2 here, 0 for the shift); in fp32 they agree
    (``test_adaln_gradients_match_jax_vjp``)."""
    rng = np.random.default_rng(31)
    n, l, d = 2, 64, 128
    arrays = [_randn(rng, n, l, d) * 2 + 0.5, _randn(rng, n, l, d)] + \
        [_randn(rng, n, 1, d) for _ in range(3)]
    cts = (_randn(rng, n, l, d), _randn(rng, n, l, d))
    bf = [torch.from_numpy(a).bfloat16() for a in arrays]
    leaves = [t.clone().requires_grad_() for t in bf]
    outs = fused_adaln.residual_adaln_modulate(*leaves)
    grads = torch.autograd.grad(
        outs, leaves, [torch.from_numpy(c).bfloat16() for c in cts])
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    ref_outs, vjp = jax.vjp(jax_fused_adaln.residual_adaln_modulate, *jx)
    ref_grads = vjp(tuple(jnp.asarray(c).astype(jnp.bfloat16) for c in cts))

    def f32(t):
        return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                          else t.astype(jnp.float32))

    assert _max_err(f32(outs[0]), f32(ref_outs[0])) == 0.0
    assert _scaled_err(f32(outs[1]), f32(ref_outs[1])) <= 2 ** -7
    errs = [_scaled_err(f32(a), f32(b)) for a, b in zip(grads, ref_grads)]
    assert max(errs) > 0.0  # the rounding difference is real
    assert max(errs) <= 0.1  # and it is of bf16 size, not a fault


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
    q256 = torch.from_numpy(_randn(rng, 1, 256, 2, 8))
    x = torch.from_numpy(_randn(rng, 1, 3, 128))
    m = torch.from_numpy(_randn(rng, 1, 128))
    attention.dot_product_attention(q, q, q)
    attention.dot_product_attention(q256, q256, q256, is_causal=True)
    fused_adaln.adaln_modulate(x, m, m)
    fused_adaln.residual_adaln_modulate(x, x, m, m, m)
    counts = ops.launch_counts()
    assert counts["flash_tail"] == counts["flash_attention"] == 0
    for key in ("adaln_modulate", "residual_adaln_modulate"):
        assert counts[key] == counts[f"{key}_fixed"] == 0
        assert counts[f"{key}_by_shape"] == {}


def test_wrappers_refuse_other_devices():
    t = torch.empty(1, 130, 2, 8, device="meta")
    with pytest.raises(ValueError):
        flash_tail.tail_masked_attention(t, t, t, 0.3)
    t = torch.empty(1, 256, 2, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention.flash_attention(t, t, t, 0.3)
    x = torch.empty(1, 3, 128, device="meta")
    with pytest.raises(ValueError):
        fused_adaln.adaln_modulate(x, x[:, 0], x[:, 0])


def test_flash_tail_supported_matches_jax():
    for shape in [(602, 602, 64), (448, 448, 64), (168, 168, 64),
                  (6, 6, 64), (1100, 1100, 64), (602, 154, 64),
                  (256, 256, 160)]:
        assert flash_tail.supported(*shape) == jax_flash_tail.supported(*shape)


def test_port_imports_no_jax():
    """Every module of the package (walked, so new modules are covered)
    imports, and nothing of JAX, flax, optax or the JAX package comes
    with it."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import opendwm_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'opendwm_tpu_torch.')]\n"
        "assert 'opendwm_tpu_torch.pipelines.lidar_maskgit' in names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from opendwm_tpu_torch import config, ops\n"
        "q = torch.randn(1, 130, 2, 8)\n"
        "ops.attention.dot_product_attention(q, q, q)\n"
        "q = torch.randn(1, 256, 2, 8)\n"
        "ops.attention.dot_product_attention(q, q, q)\n"
        "config.create_instance_from_config({'_class_name': "
        "'FlowMatchEulerScheduler', 'shift': 3.0})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'opendwm_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])


def test_port_imports_no_triton():
    """Every kernel of the port is CUDA C++ built by ``ops/_build.py``; no
    module of the package imports Triton."""
    root = Path(__file__).resolve().parents[1] / "opendwm_tpu_torch"
    bad = [str(f) for f in root.rglob("*.py")
           if any(line.split()[:2] in (["import", "triton"],
                                       ["from", "triton"])
                  or line.lstrip().startswith(("import triton.",
                                               "from triton."))
                  for line in f.read_text().splitlines())]
    assert not bad, bad


A16, A4 = 0x7F0000001000, 0x7F0000001004  # 16-byte and 4-byte aligned
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("d,dtype,mod_dtype,addresses,want", [
    (1536, BF16, BF16, (A16, A16, A16, 9 * 3072), "fixed"),
    (1536, F16, F16, (A16, A16, A16, A16, A16, 9 * 3072), "fixed"),
    (1536, F32, F32, (A16, A16, A16, 6144), "fixed"),
    (1536, BF16, BF16, (A16, A4, A16, 3072), "any"),    # an output off 16 B
    (1536, F32, F32, (A16, A16, A4, A16, 6144), "any"),  # delta off 16 B
    (1536, BF16, BF16, (A16 + 2,), "any"),
    (1536, BF16, BF16, (A16, A16, A16 + 2, 3072), "any"),  # a vector off
    (1536, BF16, BF16, (A16, A16, A16, 3074), "any"),   # its stride off
    (1536, BF16, F32, (A16, A16, A16, 6144), "any"),    # vectors in fp32
    (32, BF16, BF16, (A16, A16), "any"),
    (40, F32, F32, (A16, A16), "any"),
    (3072, BF16, BF16, (A16, A16), "any"),
    (1536, torch.float64, torch.float64, (A16, A16), "any"),
    (1024, BF16, BF16, (A16, A16, A16, 9 * 2048), "fixed"),
    (1024, F16, F16, (A16, A16, A16, A16, A16, 9 * 2048), "fixed"),
    (1024, F32, F32, (A16, A16, A16, 4096), "fixed"),
    (1024, BF16, F32, (A16, A16, A16, 4096), "any"),    # vectors in fp32
    (1024, BF16, BF16, (A16 + 2, A16, A16, 2048), "any"),  # a row off 2 B
    (1024, BF16, BF16, (A16, A16, A16, 2050), "any"),   # its stride off 2 B
])
def test_adaln_instance_rule(d, dtype, mod_dtype, addresses, want):
    """The rule that picks K3/K4's kernel in ``csrc/adaln.cu``: the ring
    only at a width it is compiled for (``RING_WIDTHS``: 1024 and 1536), in
    a type it is compiled for, with the vectors in that type and every row
    pointer, vector pointer and per-sample vector stride (bytes) a multiple
    of 16; else the runtime-width one."""
    assert fused_adaln.instance(d, dtype, mod_dtype, *addresses) == want


def test_adaln_addresses_hold_vector_strides():
    """The addresses the rule reads: each tensor's pointer and, for an
    (n, d) vector, its per-sample stride in bytes."""
    x = torch.zeros(2, 3, 8, dtype=BF16)
    mods = torch.zeros(2, 9 * 8, dtype=BF16).chunk(9, dim=-1)
    assert fused_adaln._addresses(x, mods[1]) == [
        x.data_ptr(), mods[1].data_ptr(), 9 * 8 * 2]


REPO = Path(__file__).resolve().parents[1]
XS_CONFIGS = ["ctsd_35_xs_df6v3_tirda_bm_nwao.json",
              "ctsd_35_xs_df6v3_tirda_bm_nwao_streaming.json"]


def test_every_dit_config_width_runs_the_adaln_ring():
    """Every ``DiTCrossviewTemporal`` config under ``configs/`` that the
    port builds is as wide (heads x head dim) as a width the K3/K4 ring is
    compiled for (``fused_adaln.RING_WIDTHS``), or narrower than 256 (the
    synthetic configs' 4 x 8): a config at another full width would run
    the runtime-width kernel on the card. Each is built on the meta device
    at one layer (the width does not depend on the depth); the two XS
    configs (20 x 64 with a 1536-wide adapter) are refused at build."""
    from opendwm_tpu_torch.config import create_instance_from_config, \
        get_class
    from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal

    widths, refused = {}, []
    for path in sorted(REPO.glob("configs/**/*.json")):
        model = json.loads(path.read_text()).get("pipeline", {})
        model = model.get("model") if isinstance(model, dict) else None
        if not isinstance(model, dict) or \
                get_class(model["_class_name"]) is not DiTCrossviewTemporal:
            continue
        with torch.device("meta"):
            try:
                built = create_instance_from_config(dict(model, num_layers=1))
            except ValueError as e:
                assert "ImageAdapter stage 0 is 1536 wide" in str(e)
                refused.append(path.name)
                continue
        widths[path.relative_to(REPO).as_posix()] = built.inner_dim
    assert sorted(refused) == XS_CONFIGS
    assert len(widths) == 17
    off = {k: w for k, w in widths.items()
           if w not in fused_adaln.RING_WIDTHS and w >= 256}
    assert not off, off
    assert set(widths.values()) == {32, 1024, 1536}
    assert widths["configs/lidar/lidar_diffusion_dit_temporal_ns.json"] == \
        widths["configs/lidar/lidar_diffusion_dit_temporal_kt.json"] == 1024


def _jax_pallas_flash(q, k, v, causal):
    """The JAX dispatcher forced to its stock Pallas flash attention (K7)."""
    return jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal,
        backend="pallas")


@pytest.mark.parametrize(
    "shape,kv_seq,causal",
    [
        ((2, 256, 2, 64), 256, False),  # the UNet's form (1792 at full size)
        ((2, 128, 2, 64), 256, True),   # causal, q shorter than kv
        ((1, 256, 2, 128), 384, False),  # D 128, kv longer
    ],
)
def test_flash_attention_plain_matches_pallas(interpret_pallas, shape,
                                              kv_seq, causal):
    """K7's plain version, and the port's dispatcher, against the Pallas
    flash attention (interpret mode), fp32."""
    rng = np.random.default_rng(kv_seq + causal)
    b, q_seq, h, d = shape
    q = _randn(rng, *shape)
    k, v = _randn(rng, b, kv_seq, h, d), _randn(rng, b, kv_seq, h, d)
    ref = _jax_pallas_flash(q, k, v, causal)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = flash_attention.flash_attention_plain(tq, tk, tv, d ** -0.5,
                                                  causal)
    routed = attention.dot_product_attention(tq, tk, tv, is_causal=causal)
    assert plain.shape == routed.shape == ref.shape
    assert _max_err(plain, ref) <= TOL
    assert _max_err(routed, ref) <= TOL


def test_flash_attention_supported_matches_jax():
    """``supported`` is ``_can_use_flash``'s shape rule (no bias, the
    ``pallas`` hint), over a grid of lengths and head dims."""
    for q_seq in (64, 127, 128, 200, 256, 1792, 6400):
        for kv_seq in (77, 128, 256, 1792):
            for d in (16, 64, 256, 320):
                q = np.empty((1, q_seq, 1, d), np.float32)
                k = np.empty((1, kv_seq, 1, d), np.float32)
                assert flash_attention.supported(q_seq, kv_seq, d) == \
                    jax_attention._can_use_flash(q, k, None, "pallas"), \
                    (q_seq, kv_seq, d)


def test_flash_attention_causal_is_top_left(interpret_pallas):
    """Pins an oddity of the JAX package: with q_seq != kv_seq its Pallas
    flash attention masks causal attention top-left (key j visible to
    query i iff j <= i), its XLA fallback bottom-right (j <= i + kv - q).
    The port's K7 and its plain version follow the kernel; the port's
    plain branch for other lengths follows the fallback."""
    rng = np.random.default_rng(31)
    q = _randn(rng, 1, 256, 2, 32)
    k, v = _randn(rng, 1, 512, 2, 32), _randn(rng, 1, 512, 2, 32)
    flash = _jax_pallas_flash(q, k, v, True)
    xla = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
        backend="xla")
    assert _max_err(flash, xla) > 0.5  # 2.37 here: the two masks differ
    port = attention.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True)
    assert _max_err(port, flash) <= TOL
    # the first query sees key 0 alone under the top-left mask
    np.testing.assert_allclose(np.asarray(flash)[:, 0], v[:, 0], atol=TOL)


@pytest.mark.parametrize("seq", [130, 168, 200, 336])
def test_k7_backward_plain_is_k2_at_k2_shapes(seq):
    """The identity the fold of the two backwards rests on: at K2's ragged
    lengths (q = kv, no causal mask) the K7 backward's plain version, from
    the plain forward's output and log-sum-exp (delta = rowsum(dO o O)),
    equals K2's plain version (delta = rowsum(dP o P)), fp32."""
    rng = np.random.default_rng(40 + seq)
    q, k, v, do = (torch.from_numpy(_randn(rng, 2, seq, 2, 64))
                   for _ in range(4))
    scale = 64 ** -0.5
    out, lse = flash_attention.flash_attention_forward_plain(q, k, v, scale)
    k7 = flash_attention.flash_attention_backward_plain(q, k, v, out, lse,
                                                        do, scale)
    k2 = flash_tail.tail_masked_attention_backward_plain(q, k, v, do, scale)
    for a, b in zip(k7, k2):
        assert a.shape == b.shape
        assert _scaled_err(a, b) <= TOL


@pytest.mark.parametrize(
    "q_seq,kv_seq,head_dim,causal",
    [
        (256, 256, 64, False),  # the UNet's form (1792 at full size)
        (128, 256, 64, True),   # causal, q shorter than kv
        (256, 128, 64, True),   # causal, q longer than kv
        (256, 256, 128, False),  # D 128
    ],
)
def test_flash_attention_backward_matches_pallas_vjp(interpret_pallas, q_seq,
                                                     kv_seq, head_dim,
                                                     causal):
    """K7's backward against ``jax.vjp`` of the stock Pallas flash
    attention (its ``custom_vjp`` backward, ``_flash_attention_bwd_dkv``
    and ``_flash_attention_bwd_dq``, in interpret mode), fp32: the plain
    backward on the plain forward's output and log-sum-exp, and autograd
    through the port's Function."""
    rng = np.random.default_rng(q_seq + 2 * kv_seq + head_dim + causal)
    q, ct = (_randn(rng, 1, q_seq, 2, head_dim) for _ in range(2))
    k, v = (_randn(rng, 1, kv_seq, 2, head_dim) for _ in range(2))
    scale = head_dim ** -0.5
    ref_out, ref_grads = _jax_vjp(
        lambda *a: _jax_pallas_flash(*a, causal), (q, k, v), (ct,))

    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = flash_attention.flash_attention_forward_plain(tq, tk, tv,
                                                            scale, causal)
    plain = flash_attention.flash_attention_backward_plain(
        tq, tk, tv, out, lse, tct, scale, causal)
    (port_out,), port_grads = _port_vjp(
        lambda *a: flash_attention.flash_attention(*a, scale, causal),
        (q, k, v), (ct,))
    assert _max_err(out, ref_out) <= TOL
    assert _max_err(port_out, ref_out) <= TOL
    for grads in (plain, port_grads):
        for a, b in zip(grads, ref_grads):
            assert a.shape == b.shape
            assert _scaled_err(a, b) <= TOL


def _segment_case(case, rng):
    """(q, kv segment ids, causal, rows that see no key of their segment)
    of one K7-seg case, batch 2."""
    if case == "padded_tail":  # v_flashpad's form: 200 tokens, 56 pads
        q_ids = np.zeros((2, 256), np.int32)
        q_ids[:, 200:] = 1
        return q_ids, q_ids, False, 0
    if case == "q128_kv256":  # three ids at random, q shorter than kv
        return (rng.integers(0, 3, (2, 128)).astype(np.int32),
                rng.integers(0, 3, (2, 256)).astype(np.int32), False, 0)
    # contiguous segments, so every query sees itself under the causal mask
    ids = np.zeros((2, 256), np.int32)
    ids[0, 90:] += 1
    ids[0, 170:] += 1
    ids[1, 33:] += 1
    if case == "causal":
        return ids, ids, True, 0
    q_ids = ids.copy()
    q_ids[:, ::7] = 9  # no key has id 9: those rows get the mean of V
    return q_ids, ids, False, int((q_ids == 9).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["padded_tail", "q128_kv256", "causal",
                                  "hidden_rows"])
def test_flash_attention_segment_plain_matches_pallas(interpret_pallas, case,
                                                      dtype):
    """K7-seg's plain version against the stock Pallas flash attention with
    ``SegmentIds`` (interpret mode, its default 128 blocks): fp32 to 1e-5
    max abs; bf16 to 2e-2 scaled and 5e-3 in relative norm (the stock
    kernel rounds the unnormalised p of each 128-key block to bf16, the
    plain version the normalised p). A row that sees no key of its segment
    gets the mean of V, as the stock kernel's finite mask value gives."""
    from jax.experimental.pallas.ops.tpu import flash_attention as stock

    rng = np.random.default_rng(len(case))
    q_ids, kv_ids, causal, hidden = _segment_case(case, rng)
    q = _randn(rng, 2, q_ids.shape[1], 2, 64)
    k, v = (_randn(rng, 2, kv_ids.shape[1], 2, 64) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = stock.flash_attention(
        *(jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3) for a in (q, k, v)),
        segment_ids=stock.SegmentIds(jnp.asarray(q_ids), jnp.asarray(kv_ids)),
        causal=causal, sm_scale=0.125)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3)
    ids = flash_attention.SegmentIds(torch.from_numpy(q_ids),
                                     torch.from_numpy(kv_ids))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    plain = flash_attention.flash_attention_plain(tq, tk, tv, 0.125, causal,
                                                  ids)
    routed = flash_attention.flash_attention(tq, tk, tv, 0.125, causal,
                                             segment_ids=ids)
    assert torch.equal(plain, routed) and plain.dtype == tdt
    got = plain.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32":
        assert _max_err(got, ref) <= TOL
    else:
        assert _scaled_err(got, ref) <= 2e-2
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 5e-3
    if hidden:
        rows = q_ids == 9
        mean_v = np.broadcast_to(tv.float().numpy().mean(1, keepdims=True),
                                 got.shape)
        assert rows.sum() == hidden
        assert _max_err(got[rows], mean_v[rows]) <= \
            (TOL if dtype == "float32" else 2e-2)


def test_flash_attention_segment_refuses_grad_and_bad_ids():
    """K7-seg's gradient runs its plain backward on the CPU (it no longer
    refuses one); ids must be int32 of the q and kv lengths."""
    q = torch.zeros(1, 128, 2, 16)
    ids = torch.zeros(1, 128, dtype=torch.int32)
    good = flash_attention.SegmentIds(ids, ids)
    qg = torch.randn(1, 128, 2, 16, generator=torch.Generator().manual_seed(0))
    qg.requires_grad_()
    out = flash_attention.flash_attention(qg, qg, qg, 0.25, segment_ids=good)
    (dq,) = torch.autograd.grad(out.sum(), qg)
    fwd, lse = flash_attention.flash_attention_forward_plain(
        qg.detach(), qg.detach(), qg.detach(), 0.25, segment_ids=good)
    parts = flash_attention.flash_attention_backward_plain(
        qg.detach(), qg.detach(), qg.detach(), fwd, lse, torch.ones_like(fwd),
        0.25, segment_ids=good)
    assert torch.equal(out.detach(), fwd)
    assert torch.allclose(dq, sum(parts), atol=1e-6)
    for bad in (flash_attention.SegmentIds(ids.long(), ids),
                flash_attention.SegmentIds(ids, ids[:, :64]),
                flash_attention.SegmentIds(ids[None], ids)):
        with pytest.raises(ValueError, match="segment ids"):
            flash_attention.flash_attention(q, q, q, 0.25, segment_ids=bad)
    with torch.no_grad():  # no gradient is asked for: the plain version
        out = flash_attention.flash_attention(q.requires_grad_(), q, q, 0.25,
                                              segment_ids=good)
    assert out.shape == q.shape


def test_flash_attention_segment_counts_apart_on_cpu():
    """On CPU tensors no kernel launches; the counters of K7-seg are in
    ``launch_counts`` beside K7's."""
    ops.reset_launch_counts()
    q = torch.zeros(1, 128, 2, 16)
    ids = torch.zeros(1, 128, dtype=torch.int32)
    flash_attention.flash_attention(
        q, q, q, 0.25, segment_ids=flash_attention.SegmentIds(ids, ids))
    counts = ops.launch_counts()
    assert counts["flash_attention_segment"] == 0
    assert counts["flash_attention_segment_by_shape"] == {}
    assert counts["flash_attention"] == 0
