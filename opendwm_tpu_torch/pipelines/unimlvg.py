"""UniMLVG pipeline (``opendwm_tpu/pipelines/unimlvg.py``), in PyTorch.

The CTSD pipeline with UniMLVG's autoregressive input construction
(``gen_ar_input``): ``sd`` passes the noisy latents through; ``svd``
concatenates the context latents of the first frames and a visibility
mask channel (16 + 16 + 1 input channels); ``vista`` does the same with a
random visible prefix of 0-3 frames (weights 2^i); ``pred`` replaces the
first ``visible_frame`` frames by the context latents at the reference
timestep, with the ``video_gen_ratio`` / ``image_pred_ratio`` draws in
training. Training is flow matching with output preconditioning
(``pred·(−σ) + noisy`` against the clean latents), the loss masked by
``1 − ar_mask`` under ``pred``; sampling is flow-match Euler with CFG at
batch 2, the autoregressive rollout the CTSD pipeline's.

Every draw is explicit: ``draw_ar_randoms`` / ``draw_unimlvg_randoms``
from a generator, or handed in (``loss_from_draws``, ``ar_draws``), so a
test can feed both packages the JAX draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.pipelines.ctsd import CTSDPipeline, get_conditions

# ``vista``: the visible prefix is k frames, k in 0..3 with weight 2^k.
VISTA_MAX_FRAMES = 4


def fill_svd_mask(num_init_frames: int, latent: torch.Tensor):
    """``latent`` (b, t, v, h, w, c) with all but the first
    ``num_init_frames`` frames zeroed, and the per-frame visibility mask
    channel (b, t, v, h, w, 1), zero for a sample whose kept context is
    all zero (``unimlvg.py:25``)."""
    visible = (torch.arange(latent.shape[1], device=latent.device)
               < num_init_frames)[None, :, None, None, None, None]
    ori = torch.where(visible, latent, 0.0)
    mask = visible.expand(*latent.shape[:-1], 1).to(latent.dtype)
    nonzero = ori.abs().sum(dim=tuple(range(1, ori.ndim)), keepdim=True) > 0
    return ori, mask * nonzero.to(latent.dtype)


def draw_ar_randoms(shape, style: Optional[str], train: bool,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> dict:
    """The draws of one ``gen_ar_input`` call for latents of ``shape`` (b,
    t, v, ...): ``vista``'s visible prefix (a 0-dim int tensor); in
    training under ``pred``, the task draw ``ratio`` (b, 1, 1) and the
    view-drop draw ``drop`` (b, t, v), both uniform."""
    b, t, v = shape[:3]
    if style == "vista":
        probs = torch.tensor([2.0 ** i for i in range(VISTA_MAX_FRAMES)],
                             device=device)
        return {"vista": torch.multinomial(probs, 1, generator=generator)[0]}
    if style == "pred" and train:
        return {"ratio": torch.rand((b, 1, 1), generator=generator,
                                    device=device),
                "drop": torch.rand((b, t, v), generator=generator,
                                   device=device)}
    return {}


def draw_unimlvg_randoms(shape, style: Optional[str],
                         generator: Optional[torch.Generator] = None,
                         device=None) -> dict:
    """Everything ``UnimlvgPipeline.loss_fn`` draws for latents of
    ``shape``, in the JAX package's split order (``unimlvg.py:158-160``):
    noise, the logit-normal time draw (b,), the text, box, map and context
    condition-mask uniforms (b,), and ``draw_ar_randoms``."""
    b = shape[0]

    def uniform():
        return torch.rand((b,), generator=generator, device=device)

    return {
        "noise": torch.randn(tuple(shape), generator=generator,
                             device=device),
        "time": torch.randn((b,), generator=generator, device=device),
        "text": uniform(), "box": uniform(), "map": uniform(),
        "cxt": uniform(),
        "ar": draw_ar_randoms(shape, style, True, generator, device),
    }


@register("Unimlvg", aliases=("dwm.pipelines.unimlvg.Unimlvg",))
class UnimlvgPipeline(CTSDPipeline):
    """The CTSD pipeline with UniMLVG's autoregressive input construction;
    see the module docstring."""

    @property
    def ar_input_type(self) -> Optional[str]:
        return self.common_config.get("ar_input_type")

    def gen_ar_input(self, draws: dict, noise_input: torch.Tensor,
                     latent: torch.Tensor, timesteps: torch.Tensor,
                     infer: bool,
                     cxt_condition_mask: Optional[torch.Tensor] = None,
                     first_autoregressive: bool = False):
        """(model input, timesteps, ar mask (b, t, v, 1, 1, 1) or None)
        (``unimlvg.py:46-129``); ``draws``: ``draw_ar_randoms``."""
        cc = self.common_config
        style = self.ar_input_type
        if style is None or style == "sd":
            return noise_input, timesteps, None
        if style in ("svd", "vista"):
            if style == "svd":
                lat = latent
                if cxt_condition_mask is not None:
                    lat = torch.where(cxt_condition_mask.reshape(
                        (-1,) + (1,) * (lat.ndim - 1)), lat, 0.0)
                ori, mask = fill_svd_mask(
                    cc["ar_input_cfg"]["num_init_frames"], lat)
            else:
                visible = (torch.arange(latent.shape[1], device=latent.device)
                           < draws["vista"])[None, :, None, None, None, None]
                ori = torch.where(visible, latent, 0.0)
                mask = visible.expand(*latent.shape[:-1], 1).to(latent.dtype)
            return torch.cat([noise_input, ori, mask], -1), timesteps, None
        if style != "pred":
            raise NotImplementedError(style)

        b, t, v = noise_input.shape[:3]
        base = (torch.arange(t, device=noise_input.device)
                < cc.get("visible_frame", 1)).float()[None, :, None]
        base = base.expand(b, t, v)
        if not infer:
            tc = self.training_config
            ratio_vg = tc.get("video_gen_ratio", 0.0)
            ratio_ip = tc.get("image_pred_ratio", 0.0)
            r = draws["ratio"]
            drop_views = (draws["drop"] < 0.5).float()
            mask = torch.where(r < ratio_vg, 0.0, torch.where(
                r < ratio_vg + ratio_ip, base * (1 - drop_views), base))
        elif self.inference_config.get("disable_reference", False) and \
                first_autoregressive:
            mask = torch.zeros_like(base)
        else:
            mask = base
        ref_t = cc.get("reference_timesteps", 0.0)
        new_timesteps = mask * ref_t + (1 - mask) * timesteps
        mask6 = mask[..., None, None, None]
        return mask6 * latent + (1 - mask6) * noise_input, new_timesteps, \
            mask6

    # -- training ----------------------------------------------------------

    def loss_fn(self, batch: dict, generator=None):
        """(loss, metrics) of one batch of ``latents``; draws from
        ``generator``."""
        latents = batch["latents"]
        draws = draw_unimlvg_randoms(latents.shape, self.ar_input_type,
                                     generator, latents.device)
        return self.loss_from_draws(batch, draws)

    def loss_from_draws(self, batch: dict, draws: dict):
        """The loss of ``unimlvg.py:151-211`` on given draws
        (``draw_unimlvg_randoms``); (loss, {"sd_loss": loss})."""
        latent = batch["latents"]
        b, t, v = latent.shape[:3]
        tc = self.training_config
        sched = self.train_scheduler
        noise = draws["noise"].to(latent.dtype)
        indices = sched.indices_from_draw(draws["time"])
        sigmas = sched.sigmas_at(indices).reshape(b, 1, 1, 1, 1, 1)
        noisy = sigmas * noise + (1 - sigmas) * latent
        timesteps = sched.timesteps_at(indices)[:, None, None].expand(b, t, v)

        masks = {
            f"{name}_condition_mask": draws[key] < tc.get(ratio, 1.0)
            for name, key, ratio in (
                ("text", "text", "text_prompt_condition_ratio"),
                ("box", "box", "3dbox_condition_ratio"),
                ("hdmap", "map", "hdmap_condition_ratio"),
            )
        }
        conds = get_conditions(batch, self.common_config, **masks)
        cxt_mask = draws["cxt"] < tc.get("cxt_condition_ratio", 1.0)
        model_input, timesteps, ar_mask = self.gen_ar_input(
            draws["ar"], noisy, latent, timesteps, infer=False,
            cxt_condition_mask=cxt_mask)

        pred = self.model(sample=model_input, timestep=timesteps, **conds)
        if tc.get("precondition_outputs", True):
            pred_out, target = pred * (-sigmas) + noisy, latent
        else:
            pred_out, target = pred, noise - latent
        if self.ar_input_type == "pred" and ar_mask is not None:
            pred_out, target = pred_out * (1 - ar_mask), target * (1 - ar_mask)
        loss = ((pred_out.float() - target.float()) ** 2).mean()
        return loss, {"sd_loss": loss}

    # -- inference -----------------------------------------------------------

    # no_grad, not inference_mode: an FSDP-sharded model gathers its
    # parameters in its forward, which inference tensors refuse
    @torch.no_grad()
    def inference_pipeline(
        self,
        batch: dict,
        latent_shape: tuple,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        image_latents: Optional[torch.Tensor] = None,
        reference_frame_count: int = 0,
        first_autoregressive: bool = True,
        ar_draws: Optional[Sequence[dict]] = None,
    ) -> torch.Tensor:
        """Flow-match Euler with CFG, the autoregressive input rebuilt each
        step from the context ``image_latents`` (zeros without them)
        (``unimlvg.py:213-267``). ``reference_frame_count`` is taken for the
        rollout's call and unused, as in the JAX package: ``pred`` shows
        ``visible_frame`` frames of the context. ``ar_draws``: one
        ``draw_ar_randoms`` dict a step (else drawn from ``generator``)."""
        ic = self.inference_config
        n_steps = ic["inference_steps"]
        guidance_scale = ic.get("guidance_scale", 1.0)
        do_cfg = "guidance_scale" in ic
        b, t, v = latent_shape[:3]
        sched = self.test_scheduler
        device = next(self.model.parameters()).device
        ts_table = torch.as_tensor(sched.inference_timesteps(n_steps),
                                   device=device)
        conds = get_conditions(batch, self.common_config,
                               do_classifier_free_guidance=do_cfg)
        context = image_latents if image_latents is not None else \
            torch.zeros(latent_shape, device=device)
        if noise is not None:
            latents = noise.to(device=device, dtype=torch.float32)
        else:
            latents = torch.randn(latent_shape, generator=generator,
                                  device=device, dtype=torch.float32)

        for i in range(n_steps):
            draws = ar_draws[i] if ar_draws is not None else draw_ar_randoms(
                latent_shape, self.ar_input_type, False, generator, device)
            timesteps = ts_table[i].expand(b, t, v)
            model_input, ts_in, _ = self.gen_ar_input(
                draws, latents, context, timesteps, infer=True,
                first_autoregressive=first_autoregressive)
            if do_cfg:
                model_input = torch.cat([model_input, model_input])
                ts_in = torch.cat([ts_in, ts_in])
            pred = self.model(sample=model_input, timestep=ts_in, **conds)
            if do_cfg:
                uncond, cond = pred.chunk(2)
                pred = uncond + guidance_scale * (cond - uncond)
            latents = sched.step_by_indices(
                pred, torch.full((b, t, v), i, device=device), latents,
                n_steps)
        return latents
