"""The layout-conditioned (box + map) path on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_layout_cuda.py -q

- A tiny DiT and a tiny UNet with the ImageAdapter (zero convs and gates
  drawn non-zero), fp32: the card's output (its attention through the
  kernels) within 1e-3 of the CPU's plain path; the rasters move it
  against the uncondition colour.
- A tiny bm train step from ``vae_images`` (VAE encoder, adapter, flat
  AdamW with bf16 moments) on the same draws: loss and gradient norm
  within 1e-3 relative, the bf16 first moments (0.1 of the clipped
  gradients) within 1e-2 of each tensor's largest, the moments bf16.
"""

import copy

import pytest
import torch

from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch.pipelines.ctsd import draw_training_randoms

pytestmark = pytest.mark.cuda
TOL = 1e-3
UNCOND_COLOR = 0.1255
ADAPTER = dict(in_channels=6, num_res_blocks=1, downscale_factor=2,
               use_zero_convs=True, zero_gate_coef=1.0)
DIT = dict(
    patch_size=2, num_layers=3, attention_head_dim=16, num_attention_heads=2,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=32, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, dual_attention_layers=(0,),
    enable_crossview=True, crossview_attention_type="rowwise",
    crossview_block_layers=(1,), enable_temporal=True,
    temporal_attention_type="pointwise", temporal_block_layers=(2,),
    qk_norm_on_additional_modules="rms_norm",
    condition_image_adapter_config=dict(
        ADAPTER, channels=[32, 32], is_downblocks=[True, False]))
UNET = dict(
    in_channels=4, out_channels=4, block_out_channels=(8, 16, 16),
    layers_per_block=1, num_attention_heads=(2, 2, 2),
    cross_attention_dim=12, addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=24, merge_factor=2.0,
    enable_rowwise_crossview=True, enable_rowwise_temporal=True,
    condition_image_adapter_config=dict(
        ADAPTER, channels=[8, 8, 16, 16],
        is_downblocks=[False, True, True, False]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wake_adapter(model, g):
    """Non-zero zero convs and gates: an adapter at its init adds 0."""
    adapter = model.condition_image_adapter
    with torch.no_grad():
        for conv in adapter.zero_convs:
            conv.weight.normal_(0, conv.weight[0].numel() ** -0.5,
                                generator=g)
        adapter.zero_gates.normal_(generator=g)


def _rasters(g, *shape):
    on = torch.rand(shape, generator=g) < 0.25
    return torch.rand(shape, generator=g) * on


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("kind", ["dit", "unet"])
def test_tiny_layout_denoiser_on_card_matches_cpu(cuda, kind):
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)
    if kind == "dit":  # 96 latent + 40 text tokens: 136-token joint attention
        model = DiTCrossviewTemporal(**DIT).eval()
        args = dict(
            sample=torch.randn(1, 2, 4, 16, 24, 16, generator=g),
            timestep=torch.rand(1, 2, 4, generator=g) * 1000,
            encoder_hidden_states=torch.randn(1, 2, 4, 40, 24, generator=g),
            pooled_projections=torch.randn(1, 2, 4, 16, generator=g))
    else:  # 384-token self-attention (K7), 144-token rowwise branch (K1)
        model = UNetCrossviewTemporal(**UNET).eval()
        args = dict(
            sample=torch.randn(1, 2, 6, 16, 24, 4, generator=g),
            timestep=torch.randint(0, 1000, (1, 2, 6), generator=g),
            encoder_hidden_states=torch.randn(1, 2, 6, 5, 12, generator=g),
            added_time_ids=torch.randn(1, 2, 6, 3, generator=g))
    _wake_adapter(model, g)
    b, t, v, h, w = args["sample"].shape[:5]
    rasters = _rasters(g, b, t, v, 2 * h, 2 * w, 6)
    uncond = torch.full_like(rasters, UNCOND_COLOR)
    with torch.no_grad():
        ref = model(**args, condition_image_tensor=rasters)
        ref_uncond = model(**args, condition_image_tensor=uncond)
        model.to(cuda)
        out = model(**_to(args, cuda),
                    condition_image_tensor=rasters.to(cuda)).cpu()
    assert (out - ref).abs().max().item() <= TOL
    assert (ref - ref_uncond).abs().max().item() >= 100 * TOL


def _bm_pipeline():
    model = {"_class_name": "DiTCrossviewTemporal", **copy.deepcopy(DIT),
             "param_dtype": torch.float32, "gradient_checkpointing": True}
    return create_instance_from_config({
        "_class_name": "CTSDPipeline", "model": model,
        "train_scheduler": {"_class_name": "FlowMatchEulerScheduler",
                            "shift": 3.0},
        "test_scheduler": {"_class_name": "FlowMatchEulerScheduler",
                           "shift": 3.0},
        "common_config": {"uncondition_image_color": UNCOND_COLOR},
        "training_config": {"3dbox_condition_ratio": 0.8,
                            "hdmap_condition_ratio": 0.8,
                            "max_norm_for_grad_clip": 1.0},
        "optimizer_config": {"lr": 1e-4, "weight_decay": 0.01, "flat": True,
                             "mu_dtype": "bfloat16"},
    })


def test_tiny_bm_train_step_on_card_matches_cpu(cuda):
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    ref_pipe = _bm_pipeline()
    _wake_adapter(ref_pipe.model, g)
    ref_pipe.set_vae(AutoencoderKL(block_out_channels=(8, 16),
                                   latent_channels=16, use_quant_conv=False,
                                   scaling_factor=1.5305,
                                   shift_factor=0.0609).requires_grad_(False))
    pipe = copy.deepcopy(ref_pipe)
    pipe.model.to(cuda)
    pipe.vae.to(cuda)
    batch = {  # 96 latent + 40 text tokens after the VAE's 2x encode
        "vae_images": torch.rand(1, 2, 2, 32, 48, 3, generator=g) * 2 - 1,
        "3dbox_images": _rasters(g, 1, 2, 2, 32, 48, 3),
        "hdmap_images": _rasters(g, 1, 2, 2, 32, 48, 3),
        "encoder_hidden_states": torch.randn(1, 2, 2, 40, 24, generator=g),
        "pooled_projections": torch.randn(1, 2, 2, 16, generator=g),
    }
    draws = draw_training_randoms(
        ref_pipe.vae.latent_shape(batch["vae_images"].shape),
        ref_pipe.training_config, ref_pipe.common_config, g, vae=True)
    results = []
    for p, dev in ((ref_pipe, torch.device("cpu")), (pipe, cuda)):
        state = p.init_state()
        _, metrics = p.train_step(state, _to(batch, dev), draws=_to(draws,
                                                                      dev))
        moments = [state.optimizer.state[q]["exp_avg"].cpu()
                   for q in p.model.parameters()]
        results.append(({k: v.item() for k, v in metrics.items()}, moments))
    (ref_m, ref_mu), (m, mu) = results
    for key in ("sd_loss", "grad_norm"):
        assert abs(m[key] - ref_m[key]) <= TOL * abs(ref_m[key]), key
    assert {t.dtype for t in mu} == {torch.bfloat16}
    for a, r in zip(mu, ref_mu):
        bar = max(r.float().abs().max().item(), 1e-12)
        assert (a.float() - r.float()).abs().max().item() <= 1e-2 * bar
