"""MaskGWM (``models/mask_layers.py`` and the DiT's hook), the port vs the
JAX package, on the CPU in fp32.

The masking noise is the JAX draw: the ids must be equal. The side
blocks, the controller and a masked 4-layer DiT (adapter residuals
gathered with the tokens, rowwise cross-view and pointwise temporal
branches on the shortened rows) carry the same numpy-drawn weights across
the weight bridge; outputs and gradients to 1e-3 (the DiT bar of
``test_dit_converter_parity.py``; gradients relative to their largest
entry, or 1% of the largest of all where that is more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models.mask_layers import MaskController as JaxMaskController
from opendwm_tpu.models.mask_layers import STDiT3Block as JaxSTDiT3Block
from opendwm_tpu.models.mask_layers import (
    sincos_pos_embed_3d as jax_sincos_3d,
)
from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu_torch.convert import (
    dit_flax_from_state_dict,
    dit_state_dict_from_flax,
    mask_module_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models.mask_layers import (
    MaskController,
    STDiT3Block,
    draw_mask_noise,
    sincos_pos_embed_3d,
)
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal

from torch_port_helpers import flax_init, redraw_gates

B, T, V, H, W, C = 2, 3, 2, 8, 8, 16
DIM, HEADS, HEAD_DIM = 32, 4, 8
TOL = 1e-3


def tiny_dit(**kw) -> dict:
    return dict(
        patch_size=2, num_layers=4, attention_head_dim=HEAD_DIM,
        num_attention_heads=HEADS, in_channels=C, out_channels=C,
        joint_attention_dim=24, caption_projection_dim=DIM,
        pooled_projection_dim=16, pos_embed_max_size=16, sample_size=8,
        dual_attention_layers=(0,), enable_crossview=True,
        crossview_attention_type="rowwise", crossview_block_layers=(1,),
        enable_temporal=True, temporal_attention_type="pointwise",
        temporal_block_layers=(0, 3), qk_norm_on_additional_modules="rms_norm",
        condition_image_adapter_config=dict(
            in_channels=6, channels=[DIM, DIM], is_downblocks=[True, False],
            num_res_blocks=1, downscale_factor=2, use_zero_convs=True),
        mask_module_config=dict(decode_layer=2, mask_ratio=0.25), **kw)


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {
        "sample": rng.standard_normal((B, T, V, H, W, C)),
        "timestep": rng.uniform(0, 1000, (B, T, V)),
        "encoder_hidden_states": rng.standard_normal((B, T, V, 4, 24)),
        "pooled_projections": rng.standard_normal((B, T, V, 16)),
        "condition_image_tensor": rng.uniform(
            0, 1, (B, T, V, 2 * H, 2 * W, 6)),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def _grad_err(a, b, top: float) -> float:
    """max|a - b| over the largest |b|, or over 1% of ``top`` (the largest
    gradient of all) if that is more: a gradient that is zero in exact
    arithmetic (a key bias under softmax) is all rounding, as in
    ``chip_smoke.step_errors``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-2 * top))


def test_sincos_pos_embed_3d_matches_jax():
    for args in ((32, 3, 4, 6), (1536, 6, 16, 28), (64, 2, 5, 5, 2.0, 0.5)):
        np.testing.assert_allclose(sincos_pos_embed_3d(*args),
                                   jax_sincos_3d(*args), atol=1e-6)


@pytest.mark.parametrize("kind", ["constant", "rand_t"])
def test_make_mask_ids_match_jax(kind):
    n, t, l = 6, 3, 448
    jmc = JaxMaskController(mask_ratio=0.25, mae_mask_type=kind)
    mc = MaskController(hidden_size=8, num_heads=2, attention_head_dim=4,
                        mask_ratio=0.25, mae_mask_type=kind)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = jmc.make_mask_ids(key, n, t, l)
        shape = (n, t, l) if kind == "rand_t" else (n, 1, l)
        noise = torch.tensor(np.asarray(jax.random.uniform(key, shape)))
        out = mc.make_mask_ids(noise, n, t, l)
        assert out[0].shape == (n * t, 336)  # 448 x 0.75 kept
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if kind == "constant":  # one mask for every frame
        assert torch.equal(out[3][:, 0], out[3][:, 2])
    g = torch.Generator().manual_seed(0)
    assert draw_mask_noise(n, t, l, kind, g).shape == shape


@pytest.mark.parametrize("temporal", [False, True],
                         ids=["spatial", "temporal"])
def test_stdit3_block_matches_jax(temporal):
    rng = np.random.default_rng(1)
    n, tt, s = 2, 3, 16
    x = rng.standard_normal((n, tt * s, DIM)).astype(np.float32)
    t_mlp = rng.standard_normal((n, 6 * DIM)).astype(np.float32)
    jb = JaxSTDiT3Block(heads=HEADS, head_dim=HEAD_DIM, temporal=temporal)
    params = flax_init(jb, jnp.asarray(x), None, jnp.asarray(t_mlp), seed=2,
                       T=tt, S=s)
    ref = jb.apply(params, jnp.asarray(x), None, jnp.asarray(t_mlp), tt, s)
    tb = STDiT3Block(DIM, HEADS, HEAD_DIM, temporal=temporal)
    tb.load_state_dict(to_torch(mask_module_state_dict_from_flax(params)))
    with torch.no_grad():
        out = tb(torch.from_numpy(x), torch.from_numpy(t_mlp), tt, s)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= TOL


@pytest.mark.parametrize("mix", [False, True], ids=["plain", "mix"])
def test_masking_and_reconstruction_match_jax(mix):
    """``random_masking`` (with a token-aligned residual) and
    ``mask_reconstruction`` of the controller alone, the side interpolator
    with and without its temporal blocks."""
    rng = np.random.default_rng(3)
    n, t, h, w = 4, 3, 4, 6
    x = rng.standard_normal((n, t, h * w, DIM)).astype(np.float32)
    res = rng.standard_normal((n, t, h * w, DIM)).astype(np.float32)
    temb = rng.standard_normal((n * t, DIM)).astype(np.float32)
    kw = dict(hidden_size=DIM, num_heads=HEADS, attention_head_dim=HEAD_DIM,
              decode_layer=2, mask_ratio=0.25, mae_mask_type="rand_t",
              forward_mix_interpolater=mix)
    jmc = JaxMaskController(**kw)
    key = jax.random.PRNGKey(4)
    jx, metas, jres = jmc.random_masking(key, jnp.asarray(x), h, w,
                                         [jnp.asarray(res)])
    params = flax_init(jmc, seed=5, x=jx, metas=metas, y=None,
                       temb=jnp.asarray(temb), method=jmc.mask_reconstruction)
    ref = jmc.apply(params, jx, metas, None, jnp.asarray(temb),
                    method=jmc.mask_reconstruction)

    mc = MaskController(**kw)
    mc.load_state_dict(to_torch(mask_module_state_dict_from_flax(params)))
    noise = torch.tensor(np.asarray(jax.random.uniform(key, (n, t, h * w))))
    tx, tmetas, tres = mc.random_masking(noise, torch.from_numpy(x), h, w,
                                         [torch.from_numpy(res)])
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tres[0].numpy(), np.asarray(jres[0]))
    with torch.no_grad():
        out = mc.mask_reconstruction(tx, tmetas, torch.from_numpy(temb))
        # one temb per (n): repeated over the frames
        per_n = mc.mask_reconstruction(tx, tmetas, torch.from_numpy(
            temb[::t].copy()))
    assert out.shape == (n, t, h * w, DIM)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= TOL
    ref_n = jmc.apply(params, jx, metas, None, jnp.asarray(temb[::t]),
                      method=jmc.mask_reconstruction)
    assert float(np.abs(per_n.numpy() - np.asarray(ref_n)).max()) <= TOL
    # the kept positions pass through unchanged
    kept = tmetas["mask"] == 0
    assert torch.equal(out[kept], torch.from_numpy(x)[kept])


@pytest.fixture(scope="module")
def masked_dit():
    jm = JaxDiT(**tiny_dit())
    inputs = _inputs()
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = flax_init(jm, seed=6, mask_rng=jax.random.PRNGKey(0), **jargs)
    params = {"params": redraw_gates(params["params"],
                                     np.random.default_rng(7))}
    tm = DiTCrossviewTemporal(**tiny_dit())
    tm.load_state_dict(to_torch(dit_state_dict_from_flax(params, 4)))
    return jm, params, tm, inputs


def _mask_noise(key):
    return jax.random.uniform(key, (B * V, 1, (H // 2) * (W // 2)))


def test_masked_dit_forward_and_gradient_match_jax(masked_dit):
    jm, params, tm, inputs = masked_dit
    key = jax.random.PRNGKey(8)
    jargs = {k: jnp.asarray(v) for k, v in inputs.items()}
    weight = np.random.default_rng(9).standard_normal(
        (B, T, V, H, W, C)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, **jargs, mask_rng=key)
        return jnp.sum(out * weight), out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["params"])
    targs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = tm(**targs, mask_noise=torch.tensor(np.asarray(_mask_noise(key))))
    (out * torch.from_numpy(weight)).sum().backward()
    assert float(np.abs(out.detach().numpy() - np.asarray(ref)).max()) <= TOL
    grads = {n: p.grad for n, p in tm.named_parameters()}
    want = dit_state_dict_from_flax(ref_grads, 4)
    assert grads.keys() == want.keys()
    assert any(n.startswith("mask_module.sideblocks") for n in grads)
    top = max(np.abs(w).max() for w in want.values())
    for name, g in grads.items():
        assert _grad_err(g.numpy(), want[name], top) <= TOL, name
    back = dit_flax_from_state_dict({n: p.detach() for n, p in
                                     tm.named_parameters()})
    jax.tree.map(np.testing.assert_array_equal, back["params"],
                 jax.tree.map(np.asarray, params["params"]))
    tm.zero_grad(set_to_none=True)


def test_masked_dit_in_bf16_keeps_jax_fp32_stream(masked_dit):
    """Under a bf16 compute dtype (fp32 parameters in both packages) the
    stream is fp32 from the first decoder layer on, as in JAX, where the
    fp32 mask token promotes it: the joint blocks before it take bf16,
    the blocks from it fp32, and the output stays within bf16 error of
    the JAX model's (bar 3e-2 in relative norm, as
    ``test_torch_train.py``'s bf16 forward)."""
    _, params, _, inputs = masked_dit
    key = jax.random.PRNGKey(8)
    jm = JaxDiT(**tiny_dit(), dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(jm.apply)(
        params, **{k: jnp.asarray(v) for k, v in inputs.items()},
        mask_rng=key).astype(jnp.float32))
    tm = DiTCrossviewTemporal(**tiny_dit(), dtype=torch.bfloat16,
                              param_dtype=torch.float32)
    tm.load_state_dict(to_torch(dit_state_dict_from_flax(params, 4)))
    seen = []
    for block in tm.transformer_blocks:
        block.register_forward_pre_hook(
            lambda _, args: seen.append(args[0].dtype))
    with torch.no_grad():
        out = tm(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                 mask_noise=torch.tensor(np.asarray(_mask_noise(key))))
    assert seen == [torch.bfloat16] * 2 + [torch.float32] * 2
    rel = np.linalg.norm(out.float().numpy() - ref) / np.linalg.norm(ref)
    assert rel <= 3e-2, rel


def test_masking_is_bypassed_without_noise(masked_dit):
    """Without ``mask_rng`` (JAX) or ``mask_noise`` (port) the module is
    skipped: both match; one draw masks alike twice, and masking moves the
    output."""
    jm, params, tm, inputs = masked_dit
    ref = jm.apply(params, **{k: jnp.asarray(v) for k, v in inputs.items()})
    targs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        out = tm(**targs)
        masked, again = (tm(**targs, mask_noise=draw_mask_noise(
            B * V, T, 16, generator=torch.Generator().manual_seed(0)))
            for _ in range(2))
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= TOL
    assert torch.equal(masked, again)
    assert not torch.allclose(masked, out)


def test_explicit_perspective_with_masking_fails_as_in_jax():
    """The per-token ray embedding has gh·gw tokens, the masked rows
    fewer: both packages fail to broadcast at the first branch."""
    kw = tiny_dit(perspective_modeling_type="explicit")
    inputs = _inputs()
    cams = {"camera_intrinsics_norm": np.tile(
        np.array([[0.6, 0, 0.5], [0, 0.6, 0.5], [0, 0, 1]], np.float32),
        (B, T, V, 1, 1)),
        "camera2referego": np.tile(np.eye(4, dtype=np.float32),
                                   (B, T, V, 1, 1))}
    jm = JaxDiT(**kw)
    jargs = {k: jnp.asarray(v) for k, v in {**inputs, **cams}.items()}
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), **jargs,
                                       mask_rng=jax.random.PRNGKey(1)))
    tm = DiTCrossviewTemporal(**kw)
    targs = {k: torch.from_numpy(v) for k, v in {**inputs, **cams}.items()}
    with torch.no_grad(), pytest.raises(RuntimeError, match="size"):
        tm(**targs, mask_noise=draw_mask_noise(
            B * V, T, 16, generator=torch.Generator().manual_seed(0)))
