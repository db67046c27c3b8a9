"""The port's Hopper kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances bound ``|kernel - plain| / max(1, |plain|)`` elementwise
(absolute below 1, relative above: one bf16 ulp is 2^-7 of the value, and
the two versions may round fp32 results that differ in their last bits to
neighbouring bf16 values): fp32 1e-4 for attention (fast exp, another
summation order) and 1e-5 for the normalisations; bf16 2e-2 (attention,
the bar of ``perf/exp_tailvar.py``) and 3e-2 (normalisations). The
attention backward (K2) in bf16 is held to a relative error
``||kernel - plain|| / ||plain||`` of 0.6% per gradient, the bar recorded
for the JAX kernel (``docs/PARITY.md``): its dS is rounded to bf16 at other
points than the plain version's, and its delta comes from dO.O. K7 (flash
attention) is held to the attention bars, its backward to K2's, and K5 /
K6 (the tilings of K1 in ``ops/tail_variants.py``) to the attention bars.
"""

import copy
import functools
import json
from pathlib import Path

import pytest
import torch

from opendwm_tpu_torch.config import create_instance_from_config
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch import ops
from opendwm_tpu_torch.ops import (
    flash_attention,
    flash_tail,
    fused_adaln,
    tail_variants,
)
from opendwm_tpu_torch.perf.measure import packed_segment_ids
from opendwm_tpu_torch.pipelines.ctsd import draw_training_randoms

REPO = Path(__file__).resolve().parents[1]
K2_REL_TOL = 6e-3

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


def _rel_err(a, b) -> float:
    b = b.float()
    return ((a.float() - b).norm() / b.norm()).item()


def _backward_pair(cuda, dtype, shape, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(*shape, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    out, lse = flash_tail.tail_masked_attention_forward(q, k, v, scale)
    grads = flash_tail.tail_masked_attention_backward(q, k, v, out, do, lse,
                                                      scale)
    ref = flash_tail.tail_masked_attention_backward_plain(q, k, v, do, scale)
    torch.cuda.synchronize()
    return out, grads, ref


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,seq", [(36, 602), (36, 448), (96, 168)])
def test_flash_tail_backward_kernel_matches_plain(cuda, dtype, batch, seq):
    """K2 at the training shapes (batch 1, 24 x 64 heads)."""
    _, grads, ref = _backward_pair(cuda, dtype, (batch, seq, 24, 64), seq)
    for a, b in zip(grads, ref):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.bfloat16:
            assert _rel_err(a, b) <= K2_REL_TOL
        else:
            assert _scaled_err(a, b) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq,head_dim", [(150, 40), (130, 128), (20, 16),
                                          (64, 32)])
def test_flash_tail_backward_kernel_odd_shapes(cuda, dtype, seq, head_dim):
    _, grads, ref = _backward_pair(cuda, dtype, (2, seq, 3, head_dim), seq)
    for a, b in zip(grads, ref):
        if dtype == torch.bfloat16:
            assert _rel_err(a, b) <= K2_REL_TOL
        else:
            assert _scaled_err(a, b) <= 1e-4


def test_flash_tail_grad_launches_k2(cuda):
    """A call that needs a gradient goes through K1 (with the log-sum-exp)
    and K2, and matches the autograd of the plain version."""
    g = torch.Generator(cuda).manual_seed(3)
    leaves = [torch.randn(2, 150, 3, 64, generator=g, device=cuda)
              for _ in range(3)]
    w = torch.randn(2, 150, 3, 64, generator=g, device=cuda)

    def grads(fn):
        xs = [t.clone().requires_grad_() for t in leaves]
        (fn(*xs, 0.125) * w).sum().backward()
        return [x.grad for x in xs]

    flash_tail.reset_launches()
    got = grads(flash_tail.tail_masked_attention)
    assert flash_tail.lse_launches == 1
    assert flash_tail.backward_launches_by_seq == {150: 1}
    for a, b in zip(got, grads(flash_tail.tail_masked_attention_plain)):
        assert _scaled_err(a, b) <= 1e-4


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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _one_step(pipe, batch, draws) -> dict:
    """One ``train_step``: its metrics, the gradients the optimizer received
    (after clipping), its learning rate, each parameter before and after."""
    state = pipe.init_state()
    params = list(pipe.model.parameters())
    before = [p.detach().cpu().clone() for p in params]
    seen = {}

    def grab(optimizer, *_):
        seen["lr"] = optimizer.param_groups[0]["lr"]
        seen["grads"] = [torch.zeros(p.shape) if p.grad is None
                         else p.grad.detach().cpu().clone() for p in params]

    hook = state.optimizer.register_step_pre_hook(grab)
    _, metrics = pipe.train_step(state, batch, draws=draws)
    hook.remove()
    return {**seen, "metrics": {k: v.item() for k, v in metrics.items()},
            "before": before, "after": [p.detach().cpu() for p in params]}


def _assert_step_matches(out: dict, ref: dict) -> None:
    """The loss and gradient norm to 1e-3 relative; each gradient to 1e-3
    of its largest entry, or of 1% of the largest of all gradients if that
    is more; the update to 1% of the learning rate (plus two fp32 ulps of
    the parameter) wherever the gradient is ten times that bar, so its sign
    is certain (AdamW's first step moves by about lr there; a wrong sign
    is off by 2 lr), on at least half the entries."""
    m, mr = out["metrics"], ref["metrics"]
    assert abs(m["sd_loss"] - mr["sd_loss"]) <= 1e-3 * mr["sd_loss"]
    assert abs(m["grad_norm"] - mr["grad_norm"]) <= 1e-3 * mr["grad_norm"]
    lr = ref["lr"]
    top = max(g.abs().max().item() for g in ref["grads"])
    certain = total = 0
    for i, (g, gr, b, a, ar) in enumerate(zip(
            out["grads"], ref["grads"], ref["before"], out["after"],
            ref["after"])):
        bar = 1e-3 * max(gr.abs().max().item(), 1e-2 * top)
        assert (g - gr).abs().max().item() <= bar, i
        sure = gr.abs() > 10 * bar
        ulp = torch.nextafter(b.abs(), torch.tensor(float("inf"))) - b.abs()
        gap = (a - ar).abs() - 2 * ulp
        assert gap.max().item() <= 2.02 * lr, i
        if sure.any():
            assert gap[sure].max().item() <= 1e-2 * lr, i
        certain += int(sure.sum())
        total += sure.numel()
    assert certain >= total / 2


def test_tiny_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of the tiny model, remat on: the kernel path (K1 with
    the log-sum-exp, K2, K3, K4; fp32) vs the plain path on the CPU."""
    cfg = json.loads((REPO / "configs/ctsd/ctsd_35_6views_video_synthetic"
                      ".json").read_text())["pipeline"]
    cfg["model"].update(
        num_layers=3, dual_attention_layers=[0], crossview_block_layers=[1],
        temporal_block_layers=[2], param_dtype=torch.float32,
        gradient_checkpointing=True, crossview_gradient_checkpointing=True,
        temporal_gradient_checkpointing=True)
    torch.manual_seed(0)
    pipe = create_instance_from_config(cfg)
    card = copy.deepcopy(pipe)
    card.model.to(cuda)
    g = torch.Generator().manual_seed(0)
    # 96 latent + 40 text tokens: a 136-token joint attention (K1/K2)
    batch = {
        "latents": torch.randn(1, 2, 2, 16, 24, 16, generator=g),
        "encoder_hidden_states": torch.randn(1, 2, 2, 40, 24, generator=g),
        "pooled_projections": torch.randn(1, 2, 2, 16, generator=g),
    }
    draws = draw_training_randoms(batch["latents"].shape,
                                  pipe.training_config, pipe.common_config, g)
    flash_tail.reset_launches()
    ref = _one_step(pipe, batch, draws)
    out = _one_step(card, _to(batch, cuda), _to(draws, cuda))
    assert flash_tail.backward_launches_by_seq.get(136, 0) == 3
    _assert_step_matches(out, ref)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "q_seq,kv_seq,head_dim,causal",
    [(1792, 1792, 64, False), (256, 256, 64, True), (128, 384, 64, True),
     (384, 128, 64, True), (256, 512, 128, False), (256, 256, 128, True),
     (256, 256, 256, False), (256, 384, 256, True), (200, 130, 40, True)],
)
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, q_seq,
                                              kv_seq, head_dim, causal):
    """K7 against its plain version: the UNet's shape, causal (top-left)
    with q shorter and longer than kv, head dims 64/128/256, and one
    ragged case that the dispatcher never sends (masked tails)."""
    g = torch.Generator(cuda).manual_seed(q_seq + kv_seq + head_dim)
    q = torch.randn(2, q_seq, 3, head_dim, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, kv_seq, 3, head_dim, generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    scale = head_dim ** -0.5
    out = flash_attention.flash_attention(q, k, v, scale, causal)
    ref = flash_attention.flash_attention_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert _scaled_err(out, ref) <= tol


K7_GRID = [(1792, 1792, 64, False), (256, 256, 64, True), (128, 384, 64, True),
           (384, 128, 64, True), (256, 512, 128, False),
           (256, 256, 128, True), (256, 256, 256, False),
           (256, 384, 256, True), (200, 130, 40, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_seq,kv_seq,head_dim,causal", K7_GRID)
def test_flash_attention_backward_kernel_matches_plain(cuda, dtype, q_seq,
                                                       kv_seq, head_dim,
                                                       causal):
    """The K7 backward against its plain version over the forward's grid:
    bf16 to K2's 0.6% per gradient, fp32 to 1e-4 scaled."""
    g = torch.Generator(cuda).manual_seed(q_seq + kv_seq + head_dim + causal)
    q, do = (torch.randn(2, q_seq, 3, head_dim, generator=g, device=cuda)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(2, kv_seq, 3, head_dim, generator=g, device=cuda)
            .to(dtype) for _ in range(2))
    scale = head_dim ** -0.5
    out, lse = flash_attention.flash_attention_forward(q, k, v, scale, causal)
    ref_out, ref_lse = flash_attention.flash_attention_forward_plain(
        q, k, v, scale, causal)
    grads = flash_attention.flash_attention_backward(q, k, v, out, do, lse,
                                                     scale, causal)
    ref = flash_attention.flash_attention_backward_plain(
        q, k, v, ref_out, ref_lse, do, scale, causal)
    torch.cuda.synchronize()
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for a, b in zip(grads, ref):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.bfloat16:
            assert _rel_err(a, b) <= K2_REL_TOL
        else:
            assert _scaled_err(a, b) <= 1e-4


def test_flash_attention_counts_and_refuses_grad(cuda):
    """Launch counts: serving, then a call that needs a gradient (the
    forward with the log-sum-exp, then the backward, matching the autograd
    of the plain version); a backward whose dO differs from q in dtype is
    refused."""
    flash_attention.reset_launches()
    g = torch.Generator(cuda).manual_seed(4)
    q = torch.randn(1, 256, 2, 64, generator=g, device=cuda)
    flash_attention.flash_attention(q, q, q, 0.125)
    assert flash_attention.launches_by_shape == {(1, 256, 256, 2, 64): 1}
    assert flash_attention.lse_launches == 0
    leaves = [torch.randn(1, 256, 2, 64, generator=g, device=cuda)
              for _ in range(3)]
    w = torch.randn(1, 256, 2, 64, generator=g, device=cuda)

    def grads(fn):
        xs = [t.clone().requires_grad_() for t in leaves]
        (fn(*xs, 0.125, True) * w).sum().backward()
        return [x.grad for x in xs]

    got = grads(flash_attention.flash_attention)
    assert flash_attention.lse_launches == 1
    assert flash_attention.backward_launches_by_shape == \
        {(1, 256, 256, 2, 64): 1}
    for a, b in zip(got, grads(flash_attention.flash_attention_plain)):
        assert _scaled_err(a, b) <= 1e-4
    out, lse = flash_attention.flash_attention_forward(q, q, q, 0.125)
    with pytest.raises(ValueError, match="dO"):
        flash_attention.flash_attention_backward(q, q, q, out, out.bfloat16(),
                                                 lse, 0.125)


def test_tiny_unet_on_card_matches_cpu(cuda):
    """The UNet's kernel path end to end (fp32): 16x24 latents make the
    level-0 self-attention 384 tokens (K7) and, over 6 views, the rowwise
    cross-view attention 144 tokens (K1); the rest is plain math."""
    torch.manual_seed(0)
    model = UNetCrossviewTemporal(
        in_channels=4, out_channels=4, block_out_channels=(8, 16, 16),
        layers_per_block=1, num_attention_heads=(2, 2, 2),
        cross_attention_dim=12, addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=24, merge_factor=2.0,
        enable_rowwise_crossview=True, enable_rowwise_temporal=True).eval()
    g = torch.Generator().manual_seed(0)
    b, t, v = 1, 2, 6
    args = dict(
        sample=torch.randn(b, t, v, 16, 24, 4, generator=g),
        timestep=torch.randint(0, 1000, (b, t, v), generator=g),
        encoder_hidden_states=torch.randn(b, t, v, 5, 12, generator=g),
        added_time_ids=torch.randn(b, t, v, 3, generator=g),
    )
    flash_attention.reset_launches()
    flash_tail.reset_launches()
    with torch.no_grad():
        ref = model(**args)
        out = model.to(cuda)(**{k: a.to(cuda) for k, a in args.items()})
    torch.cuda.synchronize()
    assert flash_attention.launches_by_shape == {(12, 384, 384, 2, 4): 3}
    assert flash_tail.launches_by_seq == {144: 3}
    assert (out.cpu() - ref).abs().max().item() <= 1e-3


def test_tiny_unet_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of a tiny UNet (remat on, fp32): the kernel path (K7
    and its backward at 384 tokens, K1 and K2 at 144) on the card vs the
    plain path on the CPU, on the same draws."""
    cfg = json.loads((REPO / "configs/ctsd/multi_datasets/ctsd_21_tirda_nwao"
                      ".json").read_text())["pipeline"]
    cfg["model"] = dict(
        _class_name=cfg["model"]["_class_name"], in_channels=4,
        out_channels=4, block_out_channels=[8, 16, 16], layers_per_block=1,
        num_attention_heads=[2, 2, 2], cross_attention_dim=12,
        addition_time_embed_dim=8, merge_factor=2.0,
        enable_rowwise_crossview=True, enable_rowwise_temporal=True,
        gradient_checkpointing=True, param_dtype=torch.float32)
    cfg["common_config"].pop("added_time_ids")
    cfg["training_config"]["reference_latent_count"] = 1  # frame 1 counts
    torch.manual_seed(0)
    pipe = create_instance_from_config(cfg)
    card = copy.deepcopy(pipe)
    card.model.to(cuda)
    g = torch.Generator().manual_seed(0)
    batch = {"latents": torch.randn(1, 2, 6, 16, 24, 4, generator=g),
             "encoder_hidden_states": torch.randn(1, 2, 6, 5, 12,
                                                  generator=g)}
    draws = draw_training_randoms(batch["latents"].shape,
                                  pipe.training_config, pipe.common_config, g,
                                  scheduler=pipe.train_scheduler)
    flash_attention.reset_launches()
    flash_tail.reset_launches()
    ref = _one_step(pipe, batch, draws)
    out = _one_step(card, _to(batch, cuda), _to(draws, cuda))
    assert flash_attention.backward_launches_by_shape == \
        {(12, 384, 384, 2, 4): 3}
    assert flash_tail.backward_launches_by_seq == {144: 3}
    _assert_step_matches(out, ref)


# K5 at nh 1, 2, 4 and K6 at bq 128, 256: (name, function of q, k, v, scale,
# its plain version)
TILINGS = [(f"hpack{nh}", functools.partial(tail_variants.tail_hpack, nh=nh),
            tail_variants.tail_hpack_plain) for nh in (1, 2, 4)] + \
    [(f"qsplit{bq}", functools.partial(tail_variants.tail_qsplit, bq=bq),
      tail_variants.tail_qsplit_plain) for bq in (128, 256)]


# The experiment's bars: scaled error, and relative norm (one bf16 ulp) at
# outputs far below 1, where the scaled bar is as large as they are.
TILING_TOLS = {torch.bfloat16: (2e-2, 2 ** -7), torch.float32: (1e-4, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,seq,heads,head_dim", [
    (36, 602, 24, 64), (36, 448, 24, 64), (2, 150, 4, 40), (2, 20, 4, 16),
    (2, 130, 4, 128)])
def test_tail_tilings_share_k1_arithmetic(cuda, dtype, batch, seq, heads,
                                          head_dim):
    """K5 (nh 1, 2, 4) and K6 (bq 128, 256) at the experiment's shapes and
    ragged ones (bq 256 runs 256-row blocks at S 448, 150 and 130, and is
    cut to 128 at 602 and 20; D 128 with 256-row blocks reloads Q's
    fragments), each against its plain version. K5 and K6 run one per-warp
    mma.sync tile step, so each query row goes through the same operations
    in all of them: their outputs agree bit for bit. K1 runs that step too
    except in bf16 at D 64, where it runs the Hopper forward of
    csrc/flash_fwd_sm90.cuh: there the tilings agree with K1 within the
    bars, elsewhere bit for bit."""
    g = torch.Generator(cuda).manual_seed(seq + head_dim)
    q, k, v = ((torch.randn(batch, seq, heads, head_dim, generator=g,
                            device=cuda) * 0.5).to(dtype) for _ in range(3))
    scale = head_dim ** -0.5
    tol, rel_tol = TILING_TOLS[dtype]
    out = flash_tail.tail_masked_attention(q, k, v, scale)
    ref = flash_tail.tail_masked_attention_plain(q, k, v, scale)
    assert _scaled_err(out, ref) <= tol
    k1_runs_sm90 = dtype == torch.bfloat16 and head_dim == 64
    first = None
    for name, tiling, plain in TILINGS:
        got = tiling(q, k, v, scale)
        ref = plain(q, k, v, scale)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape, name
        assert _scaled_err(got, ref) <= tol, name
        assert _rel_err(got, ref) <= rel_tol, name
        first = got if first is None else first
        assert torch.equal(got, first), name
        if k1_runs_sm90:
            assert _scaled_err(got, out) <= tol, name
            assert _rel_err(got, out) <= rel_tol, name
        else:
            assert torch.equal(got, out), name


def test_tail_tiling_launch_counts_and_checks(cuda):
    """Each launch counts once, under its nh or the bq it ran (256 is cut
    to 128 at S 602); bad arguments raise before any launch."""
    ops.reset_launch_counts()
    g = torch.Generator(cuda).manual_seed(5)
    q = torch.randn(1, 602, 4, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    q448 = q[:, :448].contiguous()
    tail_variants.tail_hpack(q, q, q, 0.125, 2)
    tail_variants.tail_hpack(q, q, q, 0.125, 4)
    tail_variants.tail_qsplit(q, q, q, 0.125, 128)
    tail_variants.tail_qsplit(q, q, q, 0.125, 256)
    tail_variants.tail_qsplit(q448, q448, q448, 0.125, 256)
    with pytest.raises(ValueError, match="divide"):
        tail_variants.tail_hpack(q, q, q, 0.125, 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        tail_variants.tail_qsplit(q, q, q, 0.125, 64)
    strided = q448.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tail_variants.tail_qsplit(strided, q448, q448, 0.125, 128)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["tail_hpack"] == 2 and counts["tail_qsplit"] == 3
    assert counts["tail_hpack_by_nh"] == {2: 1, 4: 1}
    assert counts["tail_qsplit_by_bq"] == {128: 2, 256: 1}
    assert counts["flash_tail"] == 0


# K7-seg's bars: those of the shoot-out (scaled error; relative norm, one
# bf16 ulp, since its 0.5 N(0, 1) inputs give outputs far below 1).
SEGMENT_TOLS = {torch.bfloat16: (2e-2, 2 ** -7), torch.float32: (1e-4, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    "flashpad", "packed", "packed_causal", "hidden_rows", "q_longer_causal",
    "d128_causal", "d256", "ragged_d40_causal"])
def test_flash_attention_segment_kernel_matches_plain(cuda, dtype, case):
    """K7-seg against its plain version: the shoot-out's flashpad call at
    (36, 640) (S 602, pads in segment 1); packed ids (1-4 segments a row)
    at (8, 1792), non-causal and causal; rows that share no key's id (the
    mean of V); q longer than kv under the causal mask; head dims 128 and
    256; a ragged length and head dim (masked tails)."""
    b, sq, sk, h, d, causal = {
        "flashpad": (36, 640, 640, 24, 64, False),
        "packed": (8, 1792, 1792, 24, 64, False),
        "packed_causal": (8, 1792, 1792, 24, 64, True),
        "hidden_rows": (8, 1792, 1792, 24, 64, False),
        "q_longer_causal": (2, 384, 256, 3, 64, True),
        "d128_causal": (2, 256, 256, 3, 128, True),
        "d256": (2, 384, 384, 3, 256, False),
        "ragged_d40_causal": (2, 200, 130, 3, 40, True),
    }[case]
    g = torch.Generator(cuda).manual_seed(sq + sk + d)
    q = (torch.randn(b, sq, h, d, generator=g, device=cuda) * 0.5).to(dtype)
    k, v = ((torch.randn(b, sk, h, d, generator=g, device=cuda) * 0.5)
            .to(dtype) for _ in range(2))
    if case == "flashpad":
        q_ids = torch.zeros(b, sq, dtype=torch.int32, device=cuda)
        q_ids[:, 602:] = 1
        kv_ids = q_ids
    else:
        q_ids = packed_segment_ids(b, sq, sq, cuda)
        kv_ids = q_ids if sq == sk else packed_segment_ids(b, sk, sk, cuda)
    if case == "hidden_rows":
        q_ids = q_ids.clone()
        q_ids[:, ::5] = 99
    ids = flash_attention.SegmentIds(q_ids, kv_ids)
    scale = d ** -0.5
    out = flash_attention.flash_attention(q, k, v, scale, causal,
                                          segment_ids=ids)
    ref = flash_attention.flash_attention_plain(q, k, v, scale, causal, ids)
    torch.cuda.synchronize()
    tol, rel_tol = SEGMENT_TOLS[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    assert _scaled_err(out, ref) <= tol
    assert _rel_err(out, ref) <= rel_tol
    if case == "hidden_rows":
        rows = q_ids == 99
        mean_v = v.float().mean(1, keepdim=True).expand_as(out)
        assert _scaled_err(out[rows], mean_v[rows]) <= tol


def test_flash_attention_segment_counts_apart(cuda):
    """K7-seg counts under its own counters, not K7's; with every id equal
    it is K7 bit for bit; it refuses a gradient and ids that are not int32
    of the q and kv lengths."""
    ops.reset_launch_counts()
    g = torch.Generator(cuda).manual_seed(6)
    q, k, v = (torch.randn(1, 256, 2, 64, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    ids = torch.zeros(1, 256, dtype=torch.int32, device=cuda)
    same = flash_attention.SegmentIds(ids, ids)
    seg = flash_attention.flash_attention(q, k, v, 0.125, segment_ids=same)
    plain_k7 = flash_attention.flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(seg, plain_k7)
    assert flash_attention.segment_launches_by_shape == \
        {(1, 256, 256, 2, 64): 1}
    assert flash_attention.launches_by_shape == {(1, 256, 256, 2, 64): 1}
    counts = ops.launch_counts()
    assert counts["flash_attention_segment"] == 1
    assert counts["flash_attention"] == 1
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 2"):
        flash_attention.flash_attention(q.clone().requires_grad_(), k, v,
                                        0.125, segment_ids=same)
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention.flash_attention(
            q, k, v, 0.125, segment_ids=flash_attention.SegmentIds(
                ids.long(), ids))
    with pytest.raises(ValueError, match="segment ids"):
        flash_attention.flash_attention(
            q, k, v, 0.125, segment_ids=flash_attention.SegmentIds(
                ids.cpu(), ids))
    assert flash_attention.segment_launches == 1


# The Hopper forward (csrc/flash_fwd_sm90.cuh): every bf16 launch of K1,
# K7 and K7-seg at head dim 64 with 16-byte-aligned tensors. Its bars are
# the attention's (scaled error 2e-2; relative norm one bf16 ulp, 2^-7,
# since 0.5 N(0, 1) inputs give outputs far below 1); the log-sum-exp is
# fp32 (1e-4 scaled).
SM90_TOL, SM90_REL_TOL, LSE_TOL = 2e-2, 2 ** -7, 1e-4


def _bf16_qkv(cuda, b, sq, sk, h, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    q = (torch.randn(b, sq, h, 64, generator=g, device=cuda) * 0.5) \
        .to(torch.bfloat16)
    k, v = ((torch.randn(b, sk, h, 64, generator=g, device=cuda) * 0.5)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v


def _assert_close(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert _scaled_err(out, ref) <= SM90_TOL
    assert _rel_err(out, ref) <= SM90_REL_TOL


@pytest.mark.parametrize("seq", [1, 63, 65, 168, 336, 448, 602])
def test_sm90_k1_matches_plain(cuda, seq):
    """K1 on the new body at lengths below, at and past one 64-key tile and
    at the paths' ragged lengths (TMA's zero fill and the last-tile mask),
    with and without the log-sum-exp."""
    q, k, v = _bf16_qkv(cuda, 2, seq, seq, 3, seq)
    flash_tail.reset_launches()
    out = flash_tail.tail_masked_attention(q, k, v, 0.125)
    out_lse, lse = flash_tail.tail_masked_attention_forward(q, k, v, 0.125)
    ref, ref_lse = flash_attention.flash_attention_forward_plain(q, k, v,
                                                                 0.125)
    torch.cuda.synchronize()
    assert flash_tail.launches == 2 and flash_tail.sm90_launches == 2
    _assert_close(out, ref)
    assert torch.equal(out, out_lse)
    assert _scaled_err(lse, ref_lse) <= LSE_TOL


@pytest.mark.parametrize("b,q_seq,kv_seq,heads,causal", [
    (2, 1792, 1792, 5, False), (2, 1792, 1792, 5, True),
    (2, 256, 640, 3, True), (2, 640, 256, 3, True), (2, 200, 130, 3, True),
    (2, 130, 200, 3, False)])
def test_sm90_k7_matches_plain(cuda, b, q_seq, kv_seq, heads, causal):
    """K7 on the new body: the UNet's 1792 tokens, causal (top-left) with q
    shorter and longer than kv (tiles above the diagonal skipped, the
    diagonal masked), ragged lengths; its log-sum-exp against the plain
    one."""
    q, k, v = _bf16_qkv(cuda, b, q_seq, kv_seq, heads, q_seq + kv_seq)
    flash_attention.reset_launches()
    out = flash_attention.flash_attention(q, k, v, 0.125, causal)
    out_lse, lse = flash_attention.flash_attention_forward(q, k, v, 0.125,
                                                           causal)
    ref, ref_lse = flash_attention.flash_attention_forward_plain(
        q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    assert flash_attention.sm90_launches == 2
    _assert_close(out, ref)
    assert torch.equal(out, out_lse)
    assert _scaled_err(lse, ref_lse) <= LSE_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_sm90_k7_segment_hidden_rows_are_mean_of_v(cuda, causal):
    """K7-seg on the new body with packed ids and every fifth query in a
    segment no key has: those rows equal the mean of V (non-causal; under
    the causal mask the plain version's finite mask over the visible keys),
    the rest the plain version."""
    b, s, h = 2, 1792, 3
    q, k, v = _bf16_qkv(cuda, b, s, s, h, 11)
    kv_ids = packed_segment_ids(b, s, 11, cuda)
    q_ids = kv_ids.clone()
    q_ids[:, ::5] = 99
    ids = flash_attention.SegmentIds(q_ids, kv_ids)
    flash_attention.reset_launches()
    out = flash_attention.flash_attention(q, k, v, 0.125, causal,
                                          segment_ids=ids)
    ref = flash_attention.flash_attention_plain(q, k, v, 0.125, causal, ids)
    torch.cuda.synchronize()
    assert flash_attention.sm90_launches == 1
    _assert_close(out, ref)
    if not causal:
        rows = q_ids == 99
        mean_v = v.float().mean(1, keepdim=True).expand_as(out)
        assert _rel_err(out[rows], mean_v[rows]) <= SM90_REL_TOL


@pytest.mark.parametrize("b,seq,heads", [
    (4, 602, 24), (4, 448, 24), (8, 168, 24), (8, 336, 5), (4, 448, 10),
    (8, 168, 10)])
def test_sm90_k1_equals_k7(cuda, b, seq, heads):
    """At K1's shapes (the DiT's and the UNet's, cut in batch) K1 and K7
    (non-causal, q = kv) run the one body: equal bit for bit, the output
    and the log-sum-exp."""
    q, k, v = _bf16_qkv(cuda, b, seq, seq, heads, seq + heads)
    assert torch.equal(flash_tail.tail_masked_attention(q, k, v, 0.125),
                       flash_attention.flash_attention(q, k, v, 0.125))
    out1, lse1 = flash_tail.tail_masked_attention_forward(q, k, v, 0.125)
    out7, lse7 = flash_attention.flash_attention_forward(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out1, out7) and torch.equal(lse1, lse7)


def test_sm90_dispatch_by_dtype_head_dim_alignment(cuda):
    """The rule that picks the body: bf16 at D 64 with 16-byte-aligned
    tensors runs it; fp32, D 32 or a tensor 2 bytes off alignment runs the
    mma.sync / FMA body, which still matches the plain version."""
    q, k, v = _bf16_qkv(cuda, 1, 300, 300, 2, 3)
    flat = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    cases = [((q, k, v), 1), ((q.float(), k.float(), v.float()), 0),
             ((q[..., :32].contiguous(), k[..., :32].contiguous(),
               v[..., :32].contiguous()), 0), ((shifted, k, v), 0)]
    for (a, b_, c), sm90 in cases:
        flash_tail.reset_launches()
        flash_attention.reset_launches()
        out1 = flash_tail.tail_masked_attention(a, b_, c, 0.125)
        out7 = flash_attention.flash_attention(a, b_, c, 0.125)
        ref = flash_tail.tail_masked_attention_plain(a, b_, c, 0.125)
        torch.cuda.synchronize()
        assert flash_tail.launches == 1 and flash_attention.launches == 1
        assert flash_tail.sm90_launches == sm90
        assert flash_attention.sm90_launches == sm90
        tol = SM90_TOL if a.dtype == torch.bfloat16 else 1e-4
        assert _scaled_err(out1, ref) <= tol
        assert _scaled_err(out7, ref) <= tol


# The Hopper backward (csrc/flash_bwd_sm90.cuh): every bf16 launch of K2 and
# the K7 backward at head dim 64 with the tensors TMA touches 16-byte
# aligned. Its bars are K2's (relative norm 0.6% per gradient). Its dQ is a
# sum of fp32 atomics in no fixed order: two launches, or K2 and the K7
# backward, agree in dQ within one bf16 ulp in norm (2^-7), and in dK and
# dV bit for bit.
DQ_ORDER_TOL = 2 ** -7


def _bwd_inputs(cuda, b, sq, sk, h, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    q, do = (torch.randn(b, sq, h, 64, generator=g, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, sk, h, 64, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _k2_grads(q, k, v, do, scale):
    out, lse = flash_tail.tail_masked_attention_forward(q, k, v, scale)
    return flash_tail.tail_masked_attention_backward(q, k, v, out, do, lse,
                                                     scale)


def _k7_grads(q, k, v, do, scale, causal=False):
    out, lse = flash_attention.flash_attention_forward(q, k, v, scale, causal)
    return flash_attention.flash_attention_backward(q, k, v, out, do, lse,
                                                    scale, causal)


@pytest.mark.parametrize("kernel,b,q_seq,kv_seq,heads,causal", [
    ("K2", 2, 602, 602, 3, False), ("K2", 2, 448, 448, 3, False),
    ("K2", 2, 336, 336, 5, False), ("K2", 2, 168, 168, 3, False),
    ("K7", 2, 1792, 1792, 5, False), ("K7", 2, 256, 640, 3, True),
    ("K7", 2, 640, 256, 3, True), ("K7", 2, 200, 130, 3, True)])
def test_sm90_backward_matches_plain(cuda, kernel, b, q_seq, kv_seq, heads,
                                     causal):
    """The new backward at the paths' ragged lengths (K2: 602, 448, 336,
    168; the last key and query tiles masked), the UNet's 1792 and causal
    (top-left) with q shorter and longer than kv (the query tiles before a
    key tile skipped, the diagonal masked, keys past every query at 0)."""
    q, k, v, do = _bwd_inputs(cuda, b, q_seq, kv_seq, heads, q_seq + kv_seq)
    scale = 0.125
    flash_tail.reset_launches()
    flash_attention.reset_launches()
    grads = _k2_grads(q, k, v, do, scale) if kernel == "K2" else \
        _k7_grads(q, k, v, do, scale, causal)
    ref_out, ref_lse = flash_attention.flash_attention_forward_plain(
        q, k, v, scale, causal)
    ref = flash_attention.flash_attention_backward_plain(
        q, k, v, ref_out, ref_lse, do, scale, causal)
    torch.cuda.synchronize()
    mod = flash_tail if kernel == "K2" else flash_attention
    assert mod.backward_launches == 1 and mod.sm90_backward_launches == 1
    for a, r in zip(grads, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert torch.isfinite(a).all()
        assert _rel_err(a, r) <= K2_REL_TOL


def test_sm90_backward_dk_dv_bit_stable(cuda):
    """Two launches on the same inputs: dK and dV the same bits (one block
    owns each key tile), dQ within one bf16 ulp in norm (its fp32 sums
    arrive in no fixed order)."""
    q, k, v, do = _bwd_inputs(cuda, 4, 602, 602, 24, 5)
    first = _k2_grads(q, k, v, do, 0.125)
    second = _k2_grads(q, k, v, do, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    assert _rel_err(first[0], second[0]) <= DQ_ORDER_TOL


@pytest.mark.parametrize("b,seq,heads", [
    (4, 602, 24), (4, 448, 24), (8, 168, 24), (8, 336, 5), (4, 448, 10),
    (8, 168, 10)])
def test_sm90_k2_equals_k7_backward(cuda, b, seq, heads):
    """At K2's shapes (the DiT's and the UNet's, cut in batch) K2 and the
    K7 backward run the one kernel: dK and dV equal bit for bit, dQ within
    one bf16 ulp in norm."""
    q, k, v, do = _bwd_inputs(cuda, b, seq, seq, heads, seq + heads)
    dq2, dk2, dv2 = _k2_grads(q, k, v, do, 0.125)
    dq7, dk7, dv7 = _k7_grads(q, k, v, do, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(dk2, dk7) and torch.equal(dv2, dv7)
    assert _rel_err(dq7, dq2) <= DQ_ORDER_TOL


def test_sm90_backward_dispatch_by_dtype_head_dim_alignment(cuda):
    """The rule that picks the backward's body, read from
    ``sm90_backward_launches``: bf16 at D 64 with aligned tensors runs the
    new kernel; fp32, D 128 and a q 2 bytes off alignment run the mma.sync
    / FMA bodies, which still match the plain version."""
    q, k, v, do = _bwd_inputs(cuda, 1, 300, 300, 2, 9)
    flat = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    wide = [torch.cat([t, t], dim=-1) for t in (q, k, v, do)]
    cases = [((q, k, v, do), 1), ((q.float(), k.float(), v.float(),
                                   do.float()), 0),
             (tuple(wide), 0), ((shifted, k, v, do), 0)]
    for (a, b_, c, d), sm90 in cases:
        flash_tail.reset_launches()
        flash_attention.reset_launches()
        scale = a.shape[-1] ** -0.5
        got = [_k2_grads(a, b_, c, d, scale), _k7_grads(a, b_, c, d, scale)]
        ref = flash_tail.tail_masked_attention_backward_plain(a, b_, c, d,
                                                              scale)
        torch.cuda.synchronize()
        assert flash_tail.backward_launches == 1
        assert flash_attention.backward_launches == 1
        assert flash_tail.sm90_backward_launches == sm90
        assert flash_attention.sm90_backward_launches == sm90
        for grads in got:
            for x, r in zip(grads, ref):
                if a.dtype == torch.bfloat16:
                    assert _rel_err(x, r) <= K2_REL_TOL
                else:
                    assert _scaled_err(x, r) <= 1e-4
