"""CTSD pipeline (``opendwm_tpu/pipelines/ctsd.py``), in PyTorch.

Ported: condition assembly (text, layout images, numeric camera/action
ids, the cross-view/temporal disable switches), sampling with
classifier-free guidance and reference-latent injection (flow-match Euler
for the MMDiT, ``ctsd`` and ``diffusion_forcing`` styles; DDIM for the UNet,
``model_type="unet"``), the autoregressive window rollout and the VAE
decode; and the training step of both objectives, flow matching
(``sd3``) and DDPM (``unet``, epsilon / v / sample targets):
reference-frame and diffusion-forcing input construction, condition
dropout, the loss, AdamW with clipping, freezing and accumulation. The
JAX ``lax.scan`` over steps is a Python loop here.

Randomness comes from an explicit ``torch.Generator``, and every draw can
be handed in instead: initial noise (``noise``) for sampling, and the
whole set of training draws (``draw_training_randoms`` →
``loss_from_draws``), so a test can feed both packages the JAX draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.pipelines import optim
from opendwm_tpu_torch.schedulers import (
    DDPMScheduler,
    FlowMatchEulerScheduler,
)


def _index(values: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(list(values), dtype=torch.long, device=device)


def get_camera_transform_ids(batch: dict, common_config: dict):
    """Selected intrinsics normalised by image size, then selected
    extrinsic entries (reference ctsd.py:85-95)."""
    intr = batch["camera_intrinsics"]
    intr = intr.reshape(*intr.shape[:-2], 9)
    tr = batch["camera_transforms"]
    tr = tr.reshape(*tr.shape[:-2], 16)
    ii = _index(common_config["camera_intrinsic_embedding_indices"], intr.device)
    di = _index(common_config["camera_intrinsic_denom_embedding_indices"],
                intr.device)
    ti = _index(common_config["camera_transform_embedding_indices"], tr.device)
    return torch.cat(
        [intr[..., ii] / batch["image_size"][..., di], tr[..., ti]], -1
    )


def get_action_ids(batch: dict, common_config: dict, action_condition_mask):
    """Speed (km/h) and steering from ego pose deltas (reference
    ctsd.py:97-159); unconditioned samples get -1000 sentinels."""
    ego = batch["ego_transforms"]
    ego = ego[:, :, _index(common_config["camera_ego_sensor_indices"],
                           ego.device)]
    eye = torch.eye(4, dtype=ego.dtype, device=ego.device)
    is_conditioned = (ego - eye).sum(dim=(1, 2, 3, 4)).abs() > 1e-3
    if action_condition_mask is not None:
        is_conditioned = is_conditioned & action_condition_mask
    rel = torch.linalg.solve(ego[:, :-1], ego[:, 1:])
    rel = torch.cat([rel[:, :1], rel], dim=1)
    dist = torch.linalg.norm(rel[..., :3, 3], dim=-1, keepdim=True)
    speed = 3.6 * dist * batch["fps"][:, None, None, None]
    angles = torch.atan2(
        rel[..., 1, 0:1] - rel[..., 0, 1:2],
        rel[..., 0, 0:1] + rel[..., 1, 1:2],
    )
    wheel_base, steering_ratio = 2.7, 14.0
    steering = torch.where(
        dist.abs() > 0.01,
        angles / dist.clamp(min=1e-6) * wheel_base * steering_ratio,
        -1000.0,
    )
    ids = torch.cat([speed, steering], -1)
    return torch.where(is_conditioned[:, None, None, None], ids, -1000.0)


def added_time_ids_count(common_config: dict) -> Optional[int]:
    """How many numeric ids ``get_conditions`` assembles per view, or None
    when the batch carries precomputed ids."""
    mode = common_config.get("added_time_ids")
    if mode not in ("fps_camera_transforms", "fps_camera_transforms_action"):
        return None
    count = 1 + len(common_config["camera_intrinsic_embedding_indices"]) + \
        len(common_config["camera_transform_embedding_indices"])
    return count + 2 if mode == "fps_camera_transforms_action" else count


def get_conditions(
    batch: dict,
    common_config: dict,
    *,
    text_condition_mask=None,
    box_condition_mask=None,
    hdmap_condition_mask=None,
    action_condition_mask=None,
    do_classifier_free_guidance: bool = False,
) -> dict:
    """Assemble model kwargs from a canonical batch dict of tensors.

    The batch carries pre-encoded text (``encoder_hidden_states``,
    ``pooled_projections``, optional ``uncond_*``) and channel-last layout
    rasters (``3dbox_images``, ``hdmap_images``). With CFG the
    unconditional half leads.
    """
    if common_config.get("explicit_view_modeling", False):
        raise NotImplementedError(
            "explicit view modeling is not ported yet (ROADMAP Queue 1, "
            "item 3)")
    if common_config.get("enable_depth_branch", False):
        raise NotImplementedError(
            "the depth branch is not ported yet (ROADMAP Queue 1, item 9)")
    conds: dict[str, Any] = {}
    cfg = do_classifier_free_guidance
    uncond_color = common_config.get("uncondition_image_color", 0.0)

    for key, uncond_key, mask_shape in (
        ("encoder_hidden_states", "uncond_encoder_hidden_states",
         (-1, 1, 1, 1, 1)),
        ("pooled_projections", "uncond_pooled_projections", (-1, 1, 1, 1)),
    ):
        val = batch.get(key)
        if val is None:
            continue
        uncond = batch.get(uncond_key)
        if uncond is None:
            uncond = torch.zeros_like(val)
        if text_condition_mask is not None:
            val = torch.where(text_condition_mask.reshape(mask_shape), val,
                              uncond)
        conds[key] = torch.cat([uncond, val]) if cfg else val

    images = []
    for key, mask in (
        ("3dbox_images", box_condition_mask),
        ("hdmap_images", hdmap_condition_mask),
    ):
        img = batch.get(key)
        if img is not None:
            if mask is not None:
                img = torch.where(mask.reshape(-1, 1, 1, 1, 1, 1), img,
                                  uncond_color)
            images.append(img)
    if images:
        cond_img = torch.cat(images, -1)
        if cfg:
            cond_img = torch.cat(
                [torch.full_like(cond_img, uncond_color), cond_img])
        conds["condition_image_tensor"] = cond_img

    added_mode = common_config.get("added_time_ids")
    if added_mode is None and "added_time_ids" in batch:
        ids = batch["added_time_ids"]
        conds["added_time_ids"] = torch.cat([ids, ids]) if cfg else ids
    if added_mode in ("fps_camera_transforms", "fps_camera_transforms_action"):
        b, t, v = batch["camera_transforms"].shape[:3]
        fps = batch["fps"][:, None, None, None].expand(b, t, v, 1)
        parts = [fps.to(batch["camera_transforms"].dtype),
                 get_camera_transform_ids(batch, common_config)]
        if added_mode == "fps_camera_transforms_action":
            parts.append(
                get_action_ids(batch, common_config, action_condition_mask))
        ids = torch.cat(parts, -1)
        if cfg:
            uncond = ids
            if added_mode == "fps_camera_transforms_action":
                uncond = torch.cat(
                    [ids[..., :-2], torch.full_like(ids[..., -2:], -1000.0)],
                    -1)
            ids = torch.cat([uncond, ids])
        conds["added_time_ids"] = ids

    for key in ("latents", "vae_images", "encoder_hidden_states",
                "pooled_projections", "camera_transforms", "fps"):
        if isinstance(batch.get(key), torch.Tensor):
            ref = batch[key]
            break
    else:
        ref = next(v for v in batch.values() if isinstance(v, torch.Tensor))
    bb = 2 * ref.shape[0] if cfg else ref.shape[0]
    for name in ("disable_crossview", "disable_temporal"):
        conds[name] = torch.full((bb,), bool(common_config.get(name, False)),
                                 device=ref.device)
    return conds


# Batch keys whose axis 1 is the frame axis; only these are window-sliced.
TIME_INDEXED_KEYS = frozenset({
    "latents", "vae_images", "images",
    "3dbox_images", "hdmap_images",
    "encoder_hidden_states", "pooled_projections",
    "uncond_encoder_hidden_states", "uncond_pooled_projections",
    "camera_intrinsics", "camera_transforms", "ego_transforms",
    "added_time_ids", "image_segmentation", "depth_images",
})


def slice_batch_time_window(batch: dict, start: int, length: int) -> dict:
    """Per-window view of a long-horizon batch: time-indexed entries with
    more than ``length`` frames are sliced to ``[start, start + length)``
    (clamped so a ragged last window reuses the tail); the rest pass."""
    out = {}
    for key, val in batch.items():
        if (
            key in TIME_INDEXED_KEYS
            and isinstance(val, torch.Tensor) and val.ndim >= 2
            and val.shape[1] > length
        ):
            s = max(0, min(start, val.shape[1] - length))
            out[key] = val[:, s:s + length]
        else:
            out[key] = val
    return out


# ---------------------------------------------------------------------------
# Training draws and reference-frame input construction (ctsd.py:309-423)
# ---------------------------------------------------------------------------

def draw_prediction_randoms(shape, generator=None, device=None) -> dict:
    """The seven draws of ``make_input_for_prediction`` for latents of
    ``shape`` (b, t, v, ...), in the JAX package's split order."""
    b, t, v = shape[:3]

    def normal(*s):
        return torch.randn(s, generator=generator, device=device)

    def uniform(*s):
        return torch.rand(s, generator=generator, device=device)

    return {
        "scale": normal(b, t, 1, 1, 1, 1),
        "offset": normal(b, t, 1, 1, 1, 1),
        "task": uniform(b, 1, 1),
        "image": uniform(b),
        "all_visible": uniform(b, 1, 1),
        "partial_visible": uniform(b, t, v),
        "count": uniform(b, 1, 1),
    }


def make_input_for_prediction(
    draws: dict,
    noisy_input: torch.Tensor,
    latents: torch.Tensor,
    timesteps: torch.Tensor,
    training_config: dict,
    common_config: dict,
    reference_latent_count=0,
):
    """Returns (model_input, timesteps, extra_conditions, ref_indicator).

    Styles (``common_config["frame_prediction_style"]``), as the JAX
    package's: ``None`` passes through; ``"diffusion_forcing"`` may flag
    image-generation samples (temporal off) and scales/offsets the other
    samples' input; ``"ctsd"`` splits generation from prediction tasks and
    replaces the first k frames of prediction tasks by clean latents at
    timestep 0. ``reference_latent_count`` is a count or a
    ``{count: probability}`` dict. ``draws``: ``draw_prediction_randoms``.
    """
    b, t, v = latents.shape[:3]
    tc = training_config
    scale_std = tc.get("reference_frame_scale_std")
    offset_std = tc.get("reference_frame_offset_std")
    rf_scale = draws["scale"] * scale_std + 1 if scale_std is not None \
        else 1.0
    rf_offset = draws["offset"] * offset_std if offset_std is not None \
        else 0.0
    no_ref = torch.zeros((b, t, v), dtype=torch.bool, device=latents.device)

    style = common_config.get("frame_prediction_style")
    if style is None:
        return noisy_input, timesteps, {}, no_ref

    image_draw = draws["image"].reshape(b)
    if style == "diffusion_forcing":
        disable_temporal = image_draw < tc.get("image_generation_ratio", 0.0)
        made = torch.where(disable_temporal[:, None, None, None, None, None],
                           noisy_input, noisy_input * rf_scale + rf_offset)
        return made, timesteps, {"disable_temporal": disable_temporal}, no_ref

    if style != "ctsd":
        raise ValueError(f"Unknown frame_prediction_style {style!r}")

    generation_task = draws["task"] < tc.get("generation_task_ratio", 0.0)
    disable_temporal = (
        image_draw.reshape(b, 1, 1) < tc.get("image_generation_ratio", 0.0)
    ) & generation_task
    all_visible = draws["all_visible"] < tc.get(
        "all_reference_visible_ratio", 0.0)
    partial_visible = draws["partial_visible"] < tc.get(
        "reference_visible_rate", 1.0)

    if isinstance(reference_latent_count, dict):
        counts = torch.tensor([int(c) for c in reference_latent_count],
                              device=latents.device)
        cumsum = torch.cumsum(torch.tensor(
            [float(p) for p in reference_latent_count.values()],
            dtype=torch.float32, device=latents.device), 0)
        idx = torch.searchsorted(cumsum, draws["count"].reshape(-1))
        ref_count = counts[idx.clamp(0, len(counts) - 1)].reshape(b, 1, 1)
    else:
        ref_count = torch.full((b, 1, 1), int(reference_latent_count),
                               device=latents.device)

    within_count = torch.arange(t, device=latents.device)[None, :, None] \
        < ref_count
    ref_indicator = ~generation_task & (all_visible | partial_visible) & \
        within_count
    made = torch.where(ref_indicator[..., None, None, None],
                       latents * rf_scale + rf_offset, noisy_input)
    made_t = torch.where(ref_indicator, torch.zeros_like(timesteps),
                         timesteps)
    return made, made_t, {"disable_temporal": disable_temporal.reshape(b)}, \
        ref_indicator


def draw_training_randoms(batch_shape, training_config: dict,
                          common_config: dict, generator=None,
                          device=None, scheduler=None) -> dict:
    """Everything ``CTSDPipeline.loss_fn`` draws for latents of
    ``batch_shape`` (b, t, v, h, w, c), in the JAX package's order
    (``ctsd.py:547``): noise; the train scheduler's draw per sample (per
    frame under diffusion forcing): integer timesteps for a
    ``DDPMScheduler``, else the flow-match normal or uniform draw; the
    text, box, map and action condition-mask uniforms; the prediction
    draws."""
    b, t = batch_shape[:2]
    df_mode = common_config.get(
        "frame_prediction_style") == "diffusion_forcing"
    t_shape = (b, t) if df_mode else (b,)
    noise = torch.randn(tuple(batch_shape), generator=generator,
                        device=device)
    if isinstance(scheduler, DDPMScheduler):
        time = scheduler.draw_train_timesteps(t_shape, generator, device)
    else:
        time = FlowMatchEulerScheduler.draw_for_indices(
            t_shape, generator, device,
            training_config.get("weighting_scheme", "logit_normal"))
    return {
        "noise": noise,
        "time": time,
        **{key: torch.rand((b,), generator=generator, device=device)
           for key in ("text", "box", "map", "action")},
        "prediction": draw_prediction_randoms(batch_shape, generator, device),
    }


@dataclasses.dataclass
class TrainState:
    """The training state: the step, the model (fp32 master weights), its
    AdamW optimizer and LR scheduler; and, with gradient accumulation, the
    accumulator."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_scheduler: Any
    accumulator: Optional[optim.GradientAccumulator] = None


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, {item})")


@register("CTSDPipeline", aliases=("dwm.pipelines.ctsd.CrossviewTemporalSD",))
class CTSDPipeline:
    """Training and inference of the crossview-temporal denoisers on
    canonical latent-space batches. ``model_type`` ``"sd3"``: the MMDiT,
    flow-matching training and sampling; ``"unet"``: the UNet, DDPM
    training (the train scheduler's prediction type sets the target) and
    DDIM sampling."""

    def __init__(
        self,
        model,
        train_scheduler,
        test_scheduler,
        common_config: Optional[dict] = None,
        training_config: Optional[dict] = None,
        inference_config: Optional[dict] = None,
        optimizer_config: Optional[dict] = None,
        lr_scheduler_config: Optional[dict] = None,
        mesh=None,
        model_type: str = "sd3",
        sharding_policy: Optional[str] = None,
        sharding_min_size: Optional[int] = None,
    ):
        if model_type not in ("sd3", "unet"):
            raise ValueError(f"unknown model_type {model_type!r}")
        if mesh is not None:
            raise _not_ported("device meshes", "item 13")
        self.model = model
        self.train_scheduler = train_scheduler
        self.test_scheduler = test_scheduler
        self.common_config = common_config or {}
        self.training_config = training_config or {}
        self.inference_config = inference_config or {}
        self.optimizer_config = optimizer_config
        self.lr_scheduler_config = lr_scheduler_config
        self.model_type = model_type
        self.sharding_policy = sharding_policy
        self.sharding_min_size = sharding_min_size
        self.vae = None
        count = added_time_ids_count(self.common_config)
        if count is not None and \
                getattr(model, "perspective_modeling_type", "") == "implicit":
            model.set_view_embedding_width(256 * count)
        if count is not None and hasattr(model, "set_add_embedding_width"):
            model.set_add_embedding_width(
                model.addition_time_embed_dim * count)

    # -- training ----------------------------------------------------------

    def init_state(self) -> TrainState:
        """A ``TrainState`` around ``self.model``, which must hold fp32
        master weights (``param_dtype=torch.float32``); the compute dtype
        is the model's ``dtype``."""
        model = self.model
        low = sorted({str(p.dtype) for p in model.parameters()
                      if p.dtype != torch.float32})
        if low:
            raise ValueError(
                f"training needs fp32 master weights, the model holds {low}; "
                "build it with param_dtype=torch.float32")
        tc = self.training_config
        trainable, _ = optim.split_trainable(model,
                                             tc.get("freezing_pattern"))
        optimizer, lr_scheduler = optim.build_optimizer(
            trainable, self.optimizer_config, self.lr_scheduler_config)
        accum = tc.get("gradient_accumulation_steps")
        model.train()
        return TrainState(
            step=0, model=model, optimizer=optimizer,
            lr_scheduler=lr_scheduler,
            accumulator=optim.GradientAccumulator(accum)
            if accum and accum > 1 else None,
        )

    def shard_state(self, state: TrainState):
        raise _not_ported("sharding the train state", "item 13")

    def state_shardings(self, state: TrainState):
        raise _not_ported("train-state shardings", "item 13")

    def loss_fn(self, batch: dict, generator=None):
        """(loss, metrics) of one batch; draws from ``generator``."""
        latents = self._latents(batch)
        draws = draw_training_randoms(latents.shape, self.training_config,
                                      self.common_config, generator,
                                      latents.device, self.train_scheduler)
        return self.loss_from_draws(batch, draws)

    def _latents(self, batch: dict) -> torch.Tensor:
        if "latents" not in batch:
            raise _not_ported("encoding vae_images to latents (the VAE "
                              "encoder)", "item 4")
        return batch["latents"]

    def loss_from_draws(self, batch: dict, draws: dict):
        """The loss of ``ctsd.py:541-642`` on given draws
        (``draw_training_randoms``): flow matching for ``"sd3"``, the DDPM
        target of the train scheduler for ``"unet"``;
        (loss, {"sd_loss": loss})."""
        if "depth_frustum_range" in self.common_config:
            raise _not_ported("the depth loss", "items 4 and 9")
        latents = self._latents(batch)
        tc = self.training_config
        sched = self.train_scheduler
        noise = draws["noise"].to(latents.dtype)
        if self.model_type == "sd3":
            indices = sched.indices_from_draw(
                draws["time"],
                weighting_scheme=tc.get("weighting_scheme", "logit_normal"))
            sigmas = sched.sigmas_at(indices)
            timesteps = sched.timesteps_at(indices)
            while sigmas.ndim < latents.ndim:
                sigmas = sigmas[..., None]
            noisy = sigmas * noise + (1.0 - sigmas) * latents
            target = latents
        else:  # DDPM: integer timesteps
            timesteps = draws["time"]
            noisy = sched.add_noise(latents, noise, timesteps)
            target = sched.training_target(latents, noise, timesteps)
        while timesteps.ndim < 3:
            timesteps = timesteps[..., None].repeat_interleave(
                latents.shape[timesteps.ndim], -1)

        masks = {
            f"{name}_condition_mask": draws[key] < tc.get(ratio, 1.0)
            for name, key, ratio in (
                ("text", "text", "text_prompt_condition_ratio"),
                ("box", "box", "3dbox_condition_ratio"),
                ("hdmap", "map", "hdmap_condition_ratio"),
                ("action", "action", "action_condition_ratio"),
            )
        }
        conds = get_conditions(batch, self.common_config, **masks)
        noisy, timesteps, extra, ref_indicator = make_input_for_prediction(
            draws["prediction"], noisy, latents, timesteps, tc,
            self.common_config, tc.get("reference_latent_count", 0))
        conds.update(extra)

        pred = self.model(sample=noisy, timestep=timesteps, **conds)
        pred_latent = pred * (-sigmas) + noisy if self.model_type == "sd3" \
            else pred
        if tc.get("disable_reference_frame_loss", False):
            keep = ~ref_indicator[..., None, None, None]
            pred_latent = pred_latent * keep
            target = target * keep
        loss = ((pred_latent.float() - target.float()) ** 2).mean()
        return loss, {"sd_loss": loss}

    def train_step(self, state: TrainState, batch: dict, generator=None,
                   draws: Optional[dict] = None):
        """One step: loss and gradients of every parameter, the global
        gradient norm before clipping, then (every k-th step under
        accumulation) clip the trainable gradients and apply AdamW.
        ``draws`` (``draw_training_randoms``) replaces the generator's.
        Updates ``state`` in place and returns ``(state, metrics)``."""
        model = state.model
        for p in model.parameters():
            p.grad = None
        if draws is None:
            loss, metrics = self.loss_fn(batch, generator)
        else:
            loss, metrics = self.loss_from_draws(batch, draws)
        loss.backward()
        params = list(model.parameters())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optim.global_norm(
            [p.grad for p in params if p.grad is not None])

        optim.apply_gradients(
            state.optimizer, state.lr_scheduler, state.accumulator,
            self.training_config.get("max_norm_for_grad_clip"))
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    def set_vae(self, vae) -> None:
        """Attach an ``AutoencoderKL`` for ``decode_latents``."""
        self.vae = vae

    @torch.inference_mode()
    def decode_latents(self, latents, chunk_size: Optional[int] = None):
        if self.vae is None:
            return latents
        return self.vae.decode_from_scaled(latents, chunk_size=chunk_size)

    @torch.inference_mode()
    def inference_pipeline(
        self,
        batch: dict,
        latent_shape: tuple,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        image_latents: Optional[torch.Tensor] = None,
        reference_frame_count: int = 0,
    ) -> torch.Tensor:
        """Full-sequence (or diffusion-forcing) denoise → fp32 latents.

        CFG doubles the batch; reference latents are injected at timestep 0
        each step (reference ctsd.py:1496-1575). A flow-match scheduler
        steps by ladder index, a DDIM scheduler by integer timestep: the
        injected frames' timestep 0 stays an integer (the JAX package
        turns it into a float and cannot index its tables with it; the
        stepped values of those frames are overwritten either way)."""
        ic = self.inference_config
        n_steps = ic["inference_steps"]
        guidance_scale = ic.get("guidance_scale", 1.0)
        do_cfg = "guidance_scale" in ic
        b, t, v = latent_shape[:3]
        df_mode = self.common_config.get(
            "frame_prediction_style") == "diffusion_forcing"
        sched = self.test_scheduler
        is_flow = hasattr(sched, "inference_sigmas")
        if not is_flow and not hasattr(sched, "timesteps"):
            raise ValueError(f"{type(sched).__name__} cannot sample: the "
                             "pipeline samples with flow matching or DDIM")
        if df_mode and not is_flow:
            raise ValueError("diffusion forcing steps by ladder index and "
                             "needs the flow-match scheduler")
        device = next(self.model.parameters()).device
        conds = get_conditions(batch, self.common_config,
                               do_classifier_free_guidance=do_cfg)
        ts_table = torch.as_tensor(
            sched.inference_timesteps(n_steps) if is_flow
            else sched.timesteps(n_steps), device=device)

        if df_mode and image_latents is not None:
            latents = image_latents
        elif noise is not None:
            latents = noise.to(device=device, dtype=torch.float32)
        else:
            latents = torch.randn(latent_shape, generator=generator,
                                  device=device, dtype=torch.float32)
        if tuple(latents.shape) != tuple(latent_shape):
            raise ValueError(f"initial latents {tuple(latents.shape)} != "
                             f"latent_shape {tuple(latent_shape)}")

        frames = torch.arange(t, device=device)
        if df_mode:
            clear = ic.get("clear_reference_frame_count", 0)
            if n_steps % (t - clear):
                raise ValueError("diffusion forcing needs inference_steps "
                                 "divisible by the non-reference frames")
            frame_offsets = frames * (n_steps // (t - clear))
        inject = not df_mode and image_latents is not None and \
            reference_frame_count > 0
        ref_mask = (frames < reference_frame_count)[None, :, None]

        for i in range(n_steps):
            if df_mode:
                idx = (i - frame_offsets).clamp(min=0).clamp(max=i)
                step_indices = idx[None, :, None].expand(b, t, v)
                timesteps = ts_table[step_indices]
            else:
                step_indices = torch.full((b, t, v), i, device=device)
                timesteps = ts_table[step_indices]

            model_input = latents
            if inject:
                model_input = torch.where(ref_mask[..., None, None, None],
                                          image_latents, model_input)
                timesteps = torch.where(ref_mask, 0, timesteps)
            ts_input = timesteps
            if do_cfg:
                model_input = torch.cat([model_input, model_input])
                ts_input = torch.cat([timesteps, timesteps])

            pred = self.model(sample=model_input, timestep=ts_input, **conds)
            if do_cfg:
                uncond, cond = pred.chunk(2)
                pred = uncond + guidance_scale * (cond - uncond)

            if is_flow:
                staged = sched.step_by_indices(pred, step_indices, latents,
                                               n_steps)
            else:
                staged = sched.step(pred, timesteps, latents, n_steps)
            if df_mode:
                in_range = (i - frame_offsets >= 0)[None, :, None, None,
                                                    None, None]
                latents = torch.where(in_range, staged, latents)
            else:
                latents = staged

        if inject:
            latents = torch.where(ref_mask[..., None, None, None],
                                  image_latents, latents)
        return latents

    def autoregressive_inference_pipeline(
        self,
        batch: dict,
        latent_shape: tuple,
        total_frames: int,
        reference_frame_count: int = 1,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Long-video rollout: denoise a window of t frames, slide forward
        by ``t - reference_frame_count`` carrying the last frames as
        reference latents; conditions are re-sliced per window by absolute
        frame range (reference ctsd.py:1656-1833). ``noise``, if given,
        holds one initial-noise tensor per window."""
        b, t, v = latent_shape[:3]
        stride = t - reference_frame_count
        n_windows = max(1, -(-(total_frames - t) // stride) + 1)
        if noise is not None and len(noise) != n_windows:
            raise ValueError(f"{n_windows} windows need {n_windows} noise "
                             f"tensors, got {len(noise)}")
        outputs = []
        image_latents = None
        for w in range(n_windows):
            lat = self.inference_pipeline(
                slice_batch_time_window(batch, w * stride, t), latent_shape,
                generator=generator,
                noise=None if noise is None else noise[w],
                image_latents=image_latents,
                reference_frame_count=(
                    reference_frame_count if image_latents is not None else 0
                ),
            )
            outputs.append(lat if w == 0 else lat[:, reference_frame_count:])
            tail = lat[:, -reference_frame_count:]
            pad = torch.zeros((b, stride) + tuple(lat.shape[2:]),
                              dtype=lat.dtype, device=lat.device)
            image_latents = torch.cat([tail, pad], 1)
        return torch.cat(outputs, 1)[:, :total_frames]
