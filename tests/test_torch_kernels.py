"""The port's Hopper kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances bound ``|kernel - plain| / max(1, |plain|)`` elementwise
(absolute below 1, relative above: one bf16 ulp is 2^-7 of the value, and
the two versions may round fp32 results that differ in their last bits to
neighbouring bf16 values): fp32 1e-4 for attention (fast exp, another
summation order) and 1e-5 for the normalisations; bf16 2e-2 (attention,
the bar of ``perf/exp_tailvar.py``) and 3e-2 (normalisations).
"""

import pytest
import torch

from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.ops import flash_tail, fused_adaln

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scaled_err(a, b) -> float:
    b = b.float()
    return ((a.float() - b).abs() / b.abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("seq,head_dim", [(168, 64), (602, 64), (150, 40),
                                          (130, 128), (20, 16)])
def test_flash_tail_kernel_matches_plain(cuda, dtype, tol, seq, head_dim):
    g = torch.Generator(cuda).manual_seed(seq)
    q, k, v = (torch.randn(2, seq, 3, head_dim, generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    scale = head_dim ** -0.5
    out = flash_tail.tail_masked_attention(q, k, v, scale)
    ref = flash_tail.tail_masked_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert _scaled_err(out, ref) <= tol


def test_flash_tail_refuses_grad(cuda):
    q = torch.randn(1, 130, 2, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2"):
        flash_tail.tail_masked_attention(q, q, q, 0.125)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,l,d", [(3, 154, 1536), (2, 7, 32)])
def test_fused_adaln_kernels_match_plain(cuda, dtype, tol, n, l, d):
    g = torch.Generator(cuda).manual_seed(d)
    x, delta = (torch.randn(n, l, d, generator=g, device=cuda).to(dtype)
                for _ in range(2))
    # strided per-sample vectors, as the model's modulation chunks are
    gate, scale, shift = torch.randn(
        n, 3 * d, generator=g, device=cuda).to(dtype).chunk(3, dim=-1)
    out = fused_adaln.adaln_modulate(x, scale, shift)
    ref = fused_adaln.adaln_modulate_plain(x, scale, shift)
    xo, yo = fused_adaln.residual_adaln_modulate(
        x, delta, gate[:, None], scale, shift)
    rx, ry = fused_adaln.residual_adaln_modulate_plain(
        x, delta, gate, scale, shift)
    torch.cuda.synchronize()
    for a, b in ((out, ref), (xo, rx), (yo, ry)):
        assert a.dtype == dtype
        assert _scaled_err(a, b) <= tol


def test_fused_adaln_backward_is_autograd_of_plain(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    inputs = [torch.randn(2, 5, 64, generator=g, device=cuda)] * 2 + \
        [torch.randn(2, 64, generator=g, device=cuda) for _ in range(3)]

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        xo, yo = fn(*leaves)
        (xo.square().sum() + yo.sin().sum()).backward()
        return [t.grad for t in leaves]

    for a, b in zip(grads(fused_adaln.residual_adaln_modulate),
                    grads(fused_adaln.residual_adaln_modulate_plain)):
        assert _scaled_err(a, b) <= 1e-5


def test_tiny_dit_on_card_matches_cpu(cuda):
    """The kernel path end to end (fp32) vs the plain path on the CPU."""
    torch.manual_seed(0)
    model = DiTCrossviewTemporal(
        patch_size=2, num_layers=3, attention_head_dim=16,
        num_attention_heads=2, in_channels=16, out_channels=16,
        joint_attention_dim=24, caption_projection_dim=32,
        pooled_projection_dim=16, pos_embed_max_size=16, sample_size=8,
        dual_attention_layers=(0,), enable_crossview=True,
        crossview_attention_type="rowwise", crossview_block_layers=(1,),
        enable_temporal=True, temporal_attention_type="pointwise",
        temporal_block_layers=(2,), qk_norm_on_additional_modules="rms_norm",
    ).eval()
    g = torch.Generator().manual_seed(0)
    b, t, v = 1, 2, 4
    # 96 latent + 40 text tokens make the joint attention 136 long (the
    # kernel); dual (96) and cross-view (4 x 12) attention take plain math.
    args = dict(
        sample=torch.randn(b, t, v, 16, 24, 16, generator=g),
        timestep=torch.rand(b, t, v, generator=g) * 1000,
        encoder_hidden_states=torch.randn(b, t, v, 40, 24, generator=g),
        pooled_projections=torch.randn(b, t, v, 16, generator=g),
    )
    with torch.no_grad():
        ref = model(**args)
        out = model.to(cuda)(**{k: a.to(cuda) for k, a in args.items()})
    assert (out.cpu() - ref).abs().max().item() <= 1e-3
