"""LiDAR MaskGIT pipeline, serving half
(``opendwm_tpu/pipelines/lidar_maskgit.py``), in PyTorch.

Ported: tokenization by the frozen VQ tokenizer, the T-step iterative
unmasking decode (categorical sampling, blank-code suppression for the
first 10 steps, CFG, confidence re-masking on the gamma schedule with
Gumbel noise), single-window generation and prediction
(``inference_pipeline``) and the autoregressive window rollout
(``autoregressive_inference_pipeline``), then the VQ decode and the
Gumbel-sigmoid binarisation. The JAX ``lax.scan`` over steps is a Python
loop here.

Every random draw is explicit: from a ``torch.Generator``, or replayed
from ``draws`` (a test feeds the JAX package's): per step the Gumbel
noise of the categorical draw (``jax.random.categorical`` is
``argmax(logits + gumbel)``) and the confidence uniforms, and
``gumbel_sigmoid``'s two uniforms.

The categorical step never holds the fp32 logits of all rows at once:
the head's output stays in its compute dtype and the fp32 cast, the
blank suppression, the CFG combine, the Gumbel-max draw and the chosen
probability (``exp(logit - logsumexp)``) run over chunks of at most
``SAMPLE_CHUNK_ELEMS`` logits (the temporal rollout's step holds 102,400
rows x 80,000 codes: 32.8 GB in fp32). Rows are independent, so the
chunking changes no result.

Training: the frozen tokenizer's codes, the task (generation or
prediction), the cosine-schedule mask by ranks of per-token noise
(``random_mask``), the layout dropout and the extra embedding's top-k
perturbation, then the label-smoothed (0.1) cross-entropy over the masked
tokens in fp32 and the accuracy ``acc_0``. Its draws come in the JAX
package's order (``draw_training_randoms``) or are given
(``loss_from_draws``). The cross-entropy never forms the one-hot target
or the fp32 log-softmax of all logits: ``smoothed_cross_entropy`` works on
the masked rows, ``CE_CHUNK_ELEMS`` logits at a time, forward and
backward (a full-width batch has 51,200 tokens x 80,000 codes: 16.4 GB a
copy in fp32).

``save_results`` writes the BEV previews and point dumps of a generation,
``evaluate_pipeline`` scores generations with voxel IoU, voxel difference
and the Chamfer distance (``metrics/``).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.metrics import PointCloudChamfer, VoxelDiff, VoxelIoU
from opendwm_tpu_torch.ops.voxelize import voxels_to_points
from opendwm_tpu_torch.pipelines.ctsd import build_train_state
from opendwm_tpu_torch.pipelines.lidar_vqvae import step_optimizer
from opendwm_tpu_torch.utils.preview import (
    make_lidar_bev_preview,
    save_tensor_to_image,
)

SAMPLE_CHUNK_ELEMS = 2 ** 28  # fp32 logits a chunk of the categorical step
CE_CHUNK_ELEMS = 2 ** 28  # fp32 logits a chunk of the training loss
LABEL_SMOOTHING = 0.1
BLANK_STEPS = 10  # steps that suppress the blank codes, whatever T is


def gamma_fn(mode: str = "cosine"):
    """The masking schedule: the ratio of tokens still masked at progress
    ``r`` (a float32 tensor, as the JAX schedule computes it)."""
    if mode == "linear":
        return lambda r: 1 - r
    if mode == "cosine":
        return lambda r: torch.cos(r * math.pi / 2)
    if mode == "square":
        return lambda r: 1 - r ** 2
    if mode == "cubic":
        return lambda r: 1 - r ** 3
    raise NotImplementedError(mode)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, {item})")


def random_mask(noise: torch.Tensor, mask_ratio) -> torch.Tensor:
    """Boolean mask (True = masked) of ``noise``'s shape (n, l): a token is
    masked when its noise ranks at or above ``floor(l · (1 − ratio))``
    in its row (``mask_ratio`` an fp32 scalar tensor)."""
    l = noise.shape[1]
    ranks = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1,
                          stable=True)
    ratio = torch.as_tensor(mask_ratio, dtype=torch.float32,
                            device=noise.device)
    len_keep = torch.floor(l * (1.0 - ratio)).to(torch.int32)
    return ranks >= len_keep


class SmoothedCrossEntropy(torch.autograd.Function):
    """Σ_i w_i · ce_i over the rows ``rows`` of ``logits`` (N, n) with
    ``ce = −Σ_j target_j log softmax_j``, ``target = (1 − ε) onehot(y) +
    ε / n``, which is ``lse − (1 − ε) logit_y − (ε / n) Σ_j logit_j``: in
    fp32, a chunk of rows at a time, the gradient ``w_i (softmax −
    target)`` likewise, zero on the other rows (fp32, or the logits' type
    where it is wider)."""

    @staticmethod
    def forward(ctx, logits, rows, labels, weights, eps):
        n = logits.shape[-1]
        step = max(1, CE_CHUNK_ELEMS // n)
        acc = torch.promote_types(logits.dtype, torch.float32)
        total = torch.zeros((), dtype=acc, device=logits.device)
        for r0 in range(0, rows.shape[0], step):
            lg = logits[rows[r0:r0 + step]].to(acc)
            y = labels[r0:r0 + step, None]
            ce = torch.logsumexp(lg, -1) - (1 - eps) * lg.gather(-1, y)[:, 0] \
                - (eps / n) * lg.sum(-1)
            total += (ce * weights[r0:r0 + step]).sum()
        ctx.save_for_backward(logits, rows, labels, weights)
        ctx.eps = eps
        return total

    @staticmethod
    def backward(ctx, grad):
        logits, rows, labels, weights = ctx.saved_tensors
        eps, n = ctx.eps, logits.shape[-1]
        out = torch.zeros_like(logits)
        step = max(1, CE_CHUNK_ELEMS // n)
        for r0 in range(0, rows.shape[0], step):
            r = rows[r0:r0 + step]
            acc = torch.promote_types(logits.dtype, torch.float32)
            g = torch.softmax(logits[r].to(acc), -1) - eps / n
            g.scatter_add_(-1, labels[r0:r0 + step, None],
                           torch.full_like(g[:, :1], -(1 - eps)))
            out[r] = (g * (grad * weights[r0:r0 + step])[:, None]).to(
                out.dtype)
        return out, None, None, None, None


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor, eps: float = LABEL_SMOOTHING):
    """The MaskGIT loss and accuracy over the masked tokens: ``Σ ce ·
    mask / (Σ mask + 1e-5)`` with label smoothing ``eps``, and the share
    of masked tokens whose argmax logit is the label, likewise
    normalised. logits (N, L, n), labels and mask (N, L)."""
    flat = logits.reshape(-1, logits.shape[-1])
    maskf = mask.reshape(-1).to(torch.promote_types(logits.dtype,
                                                    torch.float32))
    denom = maskf.sum() + 1e-5
    rows = mask.reshape(-1).nonzero()[:, 0]
    y = labels.reshape(-1)[rows]
    loss = SmoothedCrossEntropy.apply(flat, rows, y,
                                      maskf[rows] / denom, eps)
    with torch.no_grad():
        step = max(1, CE_CHUNK_ELEMS // flat.shape[-1])
        hits = sum(int((flat[rows[r0:r0 + step]].argmax(-1)
                        == y[r0:r0 + step]).sum())
                   for r0 in range(0, rows.shape[0], step))
        acc = torch.tensor(float(hits), device=flat.device) / denom
    return loss, acc


def gumbel_noise(shape, generator=None, device=None) -> torch.Tensor:
    """fp32 Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def gumbel_sigmoid(logits: torch.Tensor, uniforms=None, generator=None,
                   hard: bool = True, tau: float = 1.0) -> torch.Tensor:
    """Binary Gumbel relaxation of voxel logits (reference
    ``functional.py``): ``uniforms`` (u1, u2) of the logits' shape, drawn
    from ``generator`` when not given."""
    if uniforms is None:
        uniforms = [torch.rand(logits.shape, generator=generator,
                               device=logits.device) for _ in range(2)]
    g1, g2 = (-torch.log(-torch.log(u.to(logits.device) + 1e-20))
              for u in uniforms)
    soft = torch.sigmoid((logits.float() + g1 - g2) / tau)
    if hard:
        return (soft > 0.5).to(logits.dtype)
    return soft


def get_maskgit_conditions(batch: dict, *, box_condition_mask=None,
                           hdmap_condition_mask=None,
                           do_classifier_free_guidance: bool = False,
                           uncond_color: float = 0.0):
    """BEV layout raster context: the 3-D box and HD-map BEV images
    concatenated on channels, with per-sample dropout and the CFG
    unconditional half first. None when no layout is present."""
    images = []
    for key, mask in (("3dbox_bev_images", box_condition_mask),
                      ("hdmap_bev_images", hdmap_condition_mask)):
        img = batch.get(key)
        if img is not None:
            if mask is not None:
                img = torch.where(mask.reshape(-1, *(1,) * (img.ndim - 1)),
                                  img, uncond_color)
            images.append(img)
    if not images:
        return None
    ctx = torch.cat(images, -1)
    if do_classifier_free_guidance:
        ctx = torch.cat([torch.full_like(ctx, uncond_color), ctx])
    return ctx


def sample_tokens(logits: torch.Tensor, gumbel, *, guidance=None,
                  blank: Optional[torch.Tensor] = None):
    """One categorical step over ``logits`` ((2n or n, l, n_e), any float
    dtype; with ``guidance`` the unconditional half leads): in fp32 per
    chunk of rows, the (distinct) ``blank`` codes lowered by 10000, the
    CFG combine
    ``u + guidance (c − u)``, ``argmax(logits + gumbel(r0, r1))`` (the
    Gumbel noise of flat rows r0:r1) and the chosen code's probability
    ``exp(logit − logsumexp)``. Returns ((n, l) int64 ids, (n, l) fp32
    probabilities). A chunk holds ``SAMPLE_CHUNK_ELEMS`` logits."""
    n_e = logits.shape[-1]
    halves = logits.chunk(2) if guidance is not None else (logits,)
    flat = [h.reshape(-1, n_e) for h in halves]
    rows = flat[0].shape[0]
    step = max(1, SAMPLE_CHUNK_ELEMS // n_e)
    ids, probs = [], []
    for r0 in range(0, rows, step):
        r1 = min(r0 + step, rows)
        parts = [f[r0:r1].float() for f in flat]
        if blank is not None:
            for p in parts:
                p[:, blank] += -10000.0
        lg = parts[0] if guidance is None else \
            parts[0] + guidance * (parts[1] - parts[0])
        chosen = (lg + gumbel(r0, r1)).argmax(-1)
        ids.append(chosen)
        probs.append(torch.exp(lg.gather(-1, chosen[:, None])[:, 0]
                               - torch.logsumexp(lg, -1)))
    shape = halves[0].shape[:-1]
    return torch.cat(ids).reshape(shape), torch.cat(probs).reshape(shape)


@register(
    "MaskGITPipeline", aliases=("dwm.pipelines.lidar_maskgit.MaskGITPipeline",)
)
class MaskGITPipeline:
    """MaskGIT serving on a frozen VQ tokenizer (``vq_point_cloud``, its
    weights given by ``load_vq_params``) and a bidirectional transformer
    (``bi_directional_transformer``); both stay on the device they were
    moved to."""

    def __init__(self, vq_point_cloud, bi_directional_transformer,
                 common_config: Optional[dict] = None,
                 training_config: Optional[dict] = None,
                 inference_config: Optional[dict] = None,
                 optimizer_config: Optional[dict] = None,
                 lr_scheduler_config: Optional[dict] = None, mesh=None,
                 sharding_policy: Optional[str] = None,
                 sharding_min_size: Optional[int] = None,
                 blank_code: Optional[Sequence[int]] = None):
        if mesh is not None:
            raise _not_ported("device meshes", "item 13")
        self.vq = vq_point_cloud
        self.model = bi_directional_transformer
        self.common_config = common_config or {}
        self.training_config = training_config or {}
        self.inference_config = inference_config or {}
        self.optimizer_config = optimizer_config
        self.lr_scheduler_config = lr_scheduler_config
        self.blank_code = tuple(blank_code) if blank_code else ()
        self.gamma = gamma_fn(self.common_config.get("gamma_mode", "cosine"))

    # -- setup -----------------------------------------------------------

    def load_vq_params(self, state_dict: dict) -> None:
        """The tokenizer's weights (a port state dict, e.g.
        ``convert.lidar_state_dict_from_flax`` of the flax tree, or a
        ``save_model_only`` file of the port's tokenizer)."""
        self.vq.load_state_dict(state_dict)

    # -- training --------------------------------------------------------

    def init_state(self):
        """A train state around the bidirectional transformer (fp32
        masters); the tokenizer stays frozen."""
        self.vq.requires_grad_(False)
        return build_train_state(self.model, self.training_config,
                                 self.optimizer_config,
                                 self.lr_scheduler_config)

    def draw_training_randoms(self, batch: dict, generator=None) -> dict:
        """Everything ``loss_fn`` draws, in the JAX package's order
        (``lidar_maskgit.py:197``): the task and ratio uniforms, the mask
        noise (n, l), the reference-frame counts (b,) in [1, max_ref], the
        box and map dropout uniforms (b,) and the perturbation's draws."""
        points = batch["lidar_points"]
        b, t = points.shape[:2]
        dev = points.device
        h, w = self.model.img_size
        n, l = b * t, h * w
        max_ref = min(t, self.training_config.get("max_reference_frame", 3))

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        return {
            "task": uniform(), "ratio": uniform(), "mask": uniform(n, l),
            "ref": torch.randint(1, max_ref + 1, (b,), generator=generator,
                                 device=dev),
            "box": uniform(b), "map": uniform(b),
            "perturb": self.model.draw_perturbation((n, l), generator, dev),
        }

    def loss_from_draws(self, batch: dict, draws: dict):
        """(loss, {"ce_loss", "acc_0"}) of ``lidar_maskgit.py:192-251`` on
        given draws (``draw_training_randoms``)."""
        tc = self.training_config
        points, pmask = batch["lidar_points"], batch["lidar_points_mask"]
        b, t = points.shape[:2]
        _, code, idx = self.tokenize(points, pmask)
        n, l = idx.shape
        dev = idx.device
        is_prediction = draws["task"].to(dev) \
            < tc.get("task_type_ratio", 0.0)
        base = random_mask(draws["mask"].to(dev),
                           self.gamma(draws["ratio"].to(dev)))
        frame = torch.arange(t, device=dev)[None, :].expand(b, t)
        future = (frame >= draws["ref"].to(dev)[:, None]).reshape(n)[:, None]
        mask = torch.where(is_prediction, base & future, base)
        x_indices = torch.where(mask, -1, idx)
        ctx = get_maskgit_conditions(
            batch,
            box_condition_mask=draws["box"].to(dev)
            < tc.get("3dbox_condition_ratio", 1.0),
            hdmap_condition_mask=draws["map"].to(dev)
            < tc.get("hdmap_condition_ratio", 1.0))
        logits = self.model(code, x_indices, context=ctx, batch_size=b,
                            num_frames=t, perturb_draws=draws["perturb"])
        loss, acc = smoothed_cross_entropy(logits, idx, mask)
        return loss, {"ce_loss": loss, "acc_0": acc}

    def loss_fn(self, batch: dict, generator=None):
        return self.loss_from_draws(
            batch, self.draw_training_randoms(batch, generator))

    def train_step(self, state, batch: dict, generator=None,
                   draws: Optional[dict] = None):
        """One step: loss, gradients, clip and AdamW of the transformer.
        ``draws`` (``draw_training_randoms``) replaces the generator's.
        Updates ``state`` in place and returns ``(state, metrics)``."""
        if draws is None:
            draws = self.draw_training_randoms(batch, generator)
        loss, metrics = self.loss_from_draws(batch, draws)
        step_optimizer(state, loss, self.training_config)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    # -- results and evaluation ------------------------------------------

    def save_results(self, results: dict, batch: dict, output_path: str,
                     suffix: str = "0") -> list:
        """Export generation results (``lidar_maskgit.py:544-624``): a BEV
        preview PNG per sequence (ground truth | prediction, the frames
        stacked), and with ``save_pred_results`` / ``save_gt_results`` the
        occupied voxel centres as float32 ``.bin`` files padded to 5
        columns (nuScenes' LiDAR layout). Names come from
        ``batch["sample_data"]`` when it has them, else
        ``{batch:02d}_{frame:03d}``. Returns the paths written."""
        ic = self.inference_config
        written = []
        gt = results["gt_voxels"].float().cpu().numpy()
        pred = results["pred_voxels"].float().cpu().numpy()
        b, t = pred.shape[:2]

        def frame_name(bi, ti, ext):
            sd = batch.get("sample_data")
            if sd is not None:
                try:
                    name = sd[bi][ti]["filename"]
                    name = os.path.basename(
                        name[0] if isinstance(name, list) else name)
                    return os.path.splitext(name)[0] + ext
                except (KeyError, IndexError, TypeError):
                    pass
            return f"{bi:02d}_{ti:03d}{ext}"

        if ic.get("save_preview", True):
            out_dir = os.path.join(output_path, f"pred_voxel_{suffix}_preview")
            os.makedirs(out_dir, exist_ok=True)
            for bi in range(b):
                frames = make_lidar_bev_preview([gt[bi], pred[bi]])
                grid = frames.reshape(-1, *frames.shape[2:])
                path = os.path.join(out_dir, frame_name(bi, 0, ".png"))
                save_tensor_to_image(path, grid)
                written.append(path)

        def dump_points(points, mask, dirname):
            out_dir = os.path.join(output_path, dirname)
            os.makedirs(out_dir, exist_ok=True)
            for bi in range(b):
                for ti in range(t):
                    p = points[bi, ti][mask[bi, ti]].float().cpu().numpy()
                    padded = np.concatenate(
                        [p, np.zeros((p.shape[0], 2), np.float32)], -1)
                    path = os.path.join(out_dir, frame_name(bi, ti, ".bin"))
                    with open(path, "wb") as f:
                        f.write(padded.tobytes())
                    written.append(path)

        if ic.get("save_pred_results", False):
            dump_points(results["pred_points"], results["pred_points_mask"],
                        f"pred_voxel_{suffix}_samples")
        if ic.get("save_gt_results", False) and "gt_voxels" in results:
            pts, msk = voxels_to_points(results["gt_voxels"],
                                        self.vq.voxelizer)
            dump_points(pts, msk, f"gt_{suffix}_samples")
        return written

    def evaluate_pipeline(self, params, batches, generator=None,
                          global_step: int = 0,
                          metrics: Optional[dict] = None, logger=None,
                          task_type: str = "generation",
                          num_reference_frame: int = 3,
                          draws: Optional[Sequence[dict]] = None) -> dict:
        """Generate for each validation batch and score voxel IoU and
        difference and the Chamfer distance of the occupied voxel centres,
        frame by frame (``lidar_maskgit.py:626-672``); returns and logs
        ``{"evaluation/{name}": value}``. ``params``: the transformer the
        JAX signature passes (the train CLI gives its state's model, which
        is this pipeline's ``model``); ``draws[i]``: batch i's draws for
        ``inference_pipeline``, else ``generator``'s."""
        if params is not None and params is not self.model:
            raise ValueError("MaskGIT evaluates its own model; params must "
                             "be the pipeline's model (or None)")
        metrics = metrics or {"voxel_iou": VoxelIoU(),
                              "voxel_diff": VoxelDiff(),
                              "chamfer": PointCloudChamfer()}
        vox = self.vq.voxelizer
        for i, batch in enumerate(batches):
            out = self.inference_pipeline(
                batch, generator, task_type=task_type,
                num_reference_frame=num_reference_frame,
                draws=None if draws is None else draws[i])
            gt, pred = out["gt_voxels"], out["pred_voxels"]
            for name, m in metrics.items():
                if name.startswith("voxel"):
                    m.update(gt > 0.5, pred > 0.5)
                elif name.startswith("chamfer"):
                    for bi in range(gt.shape[0]):
                        for ti in range(gt.shape[1]):
                            gp, gm = voxels_to_points(gt[bi, ti], vox)
                            pp, pm = voxels_to_points(pred[bi, ti], vox)
                            m.update(pp, gp, pm, gm)
        results = {}
        for name, m in metrics.items():
            results[f"evaluation/{name}"] = m.compute()
            m.reset()
        if logger is not None:
            logger.log(global_step, results)
        return results

    # -- inference -------------------------------------------------------

    @torch.no_grad()
    def tokenize(self, points, points_mask):
        """Frozen VQ tokenize: (voxels (b, t, D, H, W), code (N, L, D),
        indices (N, L))."""
        voxels, z_q, _, idx = self.vq.encode(points, points_mask)
        return voxels, z_q, idx.reshape(z_q.shape[0], -1)

    def _lookup_codes(self, ids: torch.Tensor) -> torch.Tensor:
        return self.vq.vector_quantizer.lookup(ids)

    def _decode_draws(self, draws: Optional[dict], step: int, n_e: int,
                      generator, device):
        """(gumbel(r0, r1), confidence uniforms of shape s) of ``step``."""

        def gumbel(r0, r1):
            if draws is None:
                return gumbel_noise((r1 - r0, n_e), generator, device)
            return draws["sample"][step].reshape(-1, n_e)[r0:r1].to(device)

        def confidence(shape):
            if draws is None:
                return torch.rand(shape, generator=generator, device=device)
            return draws["confidence"][step].to(device)

        return gumbel, confidence

    @torch.inference_mode()
    def _iterative_decode(self, code_dtype, init_idx, ctx, b: int, t: int,
                          generator=None, draws: Optional[dict] = None):
        """T-step iterative unmasking over one window. ``init_idx`` (n, l)
        carries −1 at masked positions; known positions are pinned for the
        whole schedule and never re-masked. Returns (x_final,
        idx_final)."""
        ic = self.inference_config
        T = ic.get("sample_steps", self.common_config.get("T", 20))
        use_blank = ic.get("use_blank_code", True) and len(self.blank_code)
        use_maskgit = ic.get("use_maskgit", False)
        do_cfg = ic.get("do_classifier_free_guidance", False)
        guidance = ic.get("guidance_scale", 3.0) if do_cfg else None
        choice_temperature = 2.0
        device = init_idx.device
        mask_token = self.model.mask_token.to(code_dtype)
        blank = torch.as_tensor(sorted(set(self.blank_code)),
                                device=device) if use_blank else None
        unknown = init_idx == -1
        num_unknown = unknown.sum(-1)

        x = torch.where(unknown[..., None], mask_token,
                        self._lookup_codes(init_idx.clamp(min=0))
                        .to(code_dtype))
        code_idx = init_idx
        for step in range(T):
            x_in = torch.cat([x, x]) if do_cfg else x
            idx_in = torch.cat([code_idx, code_idx]) if do_cfg else code_idx
            logits = self.model(x_in, idx_in, context=ctx,
                                batch_size=2 * b if do_cfg else b,
                                num_frames=t)
            gumbel, confidence = self._decode_draws(
                draws, step, logits.shape[-1], generator, device)
            sample_ids, prob = sample_tokens(
                logits, gumbel, guidance=guidance,
                blank=blank if step < BLANK_STEPS else None)
            del logits
            known = code_idx != -1
            sample_ids = torch.where(known, code_idx, sample_ids)
            prob = torch.where(known, 1e10, prob)

            ratio = torch.tensor(step + 1.0, device=device) / T
            mask_len = torch.clamp(torch.minimum(
                (num_unknown * self.gamma(ratio)).to(torch.int32),
                num_unknown - 1), min=1)
            conf = torch.log(torch.clamp(prob, min=1e-20))
            if not use_maskgit:
                g = confidence(prob.shape)
                gumbels = -torch.log(-torch.log(torch.clamp(g, min=1e-20)))
                conf = conf + choice_temperature * (1.0 - ratio) * gumbels
            cutoff = torch.sort(conf, -1).values.gather(
                -1, mask_len[:, None].long())
            remask = (conf < cutoff) & unknown if step < T - 1 \
                else torch.zeros_like(unknown)
            code_idx = torch.where(remask, -1, sample_ids)
            x = torch.where(remask[..., None], mask_token,
                            self._lookup_codes(sample_ids).to(code_dtype))
        return x, code_idx

    @torch.inference_mode()
    def inference_pipeline(self, batch: dict, generator=None,
                           task_type: str = "generation",
                           num_reference_frame: int = 3,
                           draws: Optional[dict] = None) -> dict:
        """Iterative unmasking decode of one window: gt, predicted and
        VQ-reconstructed voxels (binary) and the code indices. ``draws``:
        ``{"decode": {"sample": [T], "confidence": [T]}, "pred_voxels":
        (u1, u2), "vq_voxels": (u1, u2)}``."""
        do_cfg = self.inference_config.get("do_classifier_free_guidance",
                                           False)
        points = batch["lidar_points"]
        b, t = points.shape[:2]
        voxels, code, code_indices = self.tokenize(
            points, batch["lidar_points_mask"])
        n = code_indices.shape[0]
        if task_type == "prediction":
            frame = torch.arange(t, device=points.device).expand(b, t)
            is_ref = (frame < num_reference_frame).reshape(n)[:, None]
            init_idx = torch.where(is_ref, code_indices, -1)
        else:
            init_idx = torch.full_like(code_indices, -1)
        ctx = get_maskgit_conditions(batch,
                                     do_classifier_free_guidance=do_cfg)
        x_final, idx_final = self._iterative_decode(
            code.dtype, init_idx, ctx, b, t, generator,
            None if draws is None else draws["decode"])
        _, pred_logits = self.vq.lidar_decoder(x_final)
        return self._finish_inference(pred_logits, code, voxels, idx_final,
                                      b, t, task_type, generator, draws)

    @torch.inference_mode()
    def autoregressive_inference_pipeline(
            self, batch: dict, generator=None,
            num_reference_frame: Optional[int] = None,
            window_frames: Optional[int] = None,
            use_ground_truth_as_reference: bool = True,
            draws: Optional[Sequence[dict]] = None) -> dict:
        """Long-horizon rollout: decode a window of ``window_frames``,
        slide forward carrying the last ``num_reference_frame`` frames'
        sampled codes as the next window's pinned tokens; the BEV layout is
        re-sliced per window by absolute frame range (a short last window
        repeats its last frame). ``draws``: one ``{"decode": ...,
        "voxels": (u1, u2)}`` a window. Returns pred/gt voxels (b, total,
        D, H, W), the predicted indices and points with their masks."""
        ic, cc, tc = (self.inference_config, self.common_config,
                      self.training_config)
        ref = num_reference_frame or cc.get("max_reference_frame", 3)
        tw = window_frames or tc.get("num_training_frames", 8)
        do_cfg = ic.get("do_classifier_free_guidance", False)
        points = batch["lidar_points"]
        b, total = points.shape[:2]
        if tw <= ref:
            raise ValueError(f"window_frames {tw} must exceed "
                             f"num_reference_frame {ref}")
        n_windows = max(1, -(-(total - ref) // (tw - ref)))
        if draws is not None and len(draws) != n_windows:
            raise ValueError(f"{n_windows} windows need {n_windows} draws")

        gt_voxels, _, all_indices = self.tokenize(
            points, batch["lidar_points_mask"])
        l = all_indices.shape[-1]
        all_indices = all_indices.reshape(b, total, l)

        def window_conditions(start: int, end: int):
            wb = {}
            for key in ("3dbox_bev_images", "hdmap_bev_images"):
                x = batch.get(key)
                if x is None:
                    continue
                if x.ndim == 4:  # flattened (b * total, H, W, C)
                    x = x.reshape(b, total, *x.shape[1:])
                x = x[:, start:end]
                if end - start < tw:
                    pad = x[:, -1:].expand(-1, tw - (end - start),
                                           *x.shape[2:])
                    x = torch.cat([x, pad], 1)
                wb[key] = x.reshape(b * tw, *x.shape[2:])
            return get_maskgit_conditions(
                wb, do_classifier_free_guidance=do_cfg,
                uncond_color=cc.get("uncondition_image_color", 0.0))

        device = points.device
        is_ref_row = (torch.arange(tw, device=device) < ref)[None, :, None]
        is_ref_row = is_ref_row.expand(b, tw, l).reshape(b * tw, l)
        ref_ids = all_indices[:, :ref] if use_ground_truth_as_reference \
            else None
        outputs_vox, outputs_idx = [], []
        for w in range(n_windows):
            start = w * (tw - ref)
            end = min(start + tw, total)
            ctx = window_conditions(start, end)
            if ref_ids is None:
                init_idx = torch.full((b * tw, l), -1, dtype=torch.long,
                                      device=device)
            else:
                pad = torch.full((b, tw - ref, l), -1, dtype=ref_ids.dtype,
                                 device=device)
                padded = torch.cat([ref_ids, pad], 1).reshape(b * tw, l)
                init_idx = torch.where(is_ref_row, padded, -1)
            win = None if draws is None else draws[w]
            x_final, idx_final = self._iterative_decode(
                torch.float32, init_idx, ctx, b, tw, generator,
                None if win is None else win["decode"])
            _, logits = self.vq.lidar_decoder(x_final)
            vox = gumbel_sigmoid(logits, None if win is None
                                 else win["voxels"], generator)
            vox = vox.reshape(b, tw, *vox.shape[1:])
            ids = idx_final.reshape(b, tw, l)
            crop = 0 if w == 0 else ref
            outputs_vox.append(vox[:, crop:])
            outputs_idx.append(ids[:, crop:])
            ref_ids = ids[:, -ref:]

        pred_voxels = torch.cat(outputs_vox, 1)[:, :total]
        pred_indices = torch.cat(outputs_idx, 1)[:, :total]
        pred_points, pred_points_mask = voxels_to_points(pred_voxels,
                                                         self.vq.voxelizer)
        return {"gt_voxels": gt_voxels, "pred_voxels": pred_voxels,
                "pred_indices": pred_indices, "pred_points": pred_points,
                "pred_points_mask": pred_points_mask,
                "task_type": "autoregressive_prediction"}

    def _finish_inference(self, pred_logits, code, voxels, idx_final, b, t,
                          task_type, generator=None, draws=None):
        _, vq_logits = self.vq.lidar_decoder(code)
        pred = gumbel_sigmoid(pred_logits, None if draws is None
                              else draws["pred_voxels"], generator)
        vq = gumbel_sigmoid(vq_logits, None if draws is None
                            else draws["vq_voxels"], generator)
        return {
            "gt_voxels": voxels.reshape(b, t, *voxels.shape[2:]),
            "pred_voxels": pred.reshape(b, t, *pred.shape[1:]),
            "vq_voxels": vq.reshape(b, t, *vq.shape[1:]),
            "pred_indices": idx_final.reshape(b, t, -1),
            "task_type": task_type,
        }
