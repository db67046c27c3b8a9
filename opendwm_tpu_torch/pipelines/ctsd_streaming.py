"""Streaming CTSD (``opendwm_tpu/pipelines/ctsd_streaming.py``), in
PyTorch: frame-in, frame-out FIFO diffusion for interactive use.

A window of T latents sits at staggered noise levels (diffusion forcing).
Each incoming frame condition joins the tail of the condition queue; one
``step_stream`` runs ``steps_per_inference`` denoise iterations over the
whole window, which completes the oldest frame: it pops as the output and
fresh noise joins at the tail. The first T ticks fill the queue
(``ready`` False), after which every tick costs the same.

The state is a dataclass (latents, the condition queue, the frame count,
a ``torch.Generator`` for the tail noise, the unconditional text); the
JAX ``lax.scan`` over steps is a Python loop under ``torch.no_grad()``,
and the tail noise can be handed in, so a test can feed the JAX draw.

Over data ranks a stream whose batch divides by them is split: each rank
serves its rows, its noise its rows of the global draws; a stream that
does not divide (batch 1, the usual stream) is served whole by every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.parallel.sharding import data_parallel_size
from opendwm_tpu_torch.pipelines.ctsd import CTSDPipeline, get_conditions


@dataclasses.dataclass
class StreamingState:
    latents: torch.Tensor          # (b, T, v, h, w, c)
    conditions: dict               # (b, T, v, ...) queues; others pass
    frames_received: int
    generator: Optional[torch.Generator] = None
    # Unconditional text for CFG: single-frame (b, 1, v, ...) tensors,
    # broadcast over the queue at guidance time. None: zeros.
    uncond_text: Optional[dict] = None
    # Whether the data ranks split the stream's batch (each serves its
    # rows, its noise the rows of the global draws); else every rank
    # serves the whole stream.
    split: bool = False


_TEXT_KEYS = ("encoder_hidden_states", "pooled_projections")


def _is_queue(q) -> bool:
    return isinstance(q, torch.Tensor) and q.ndim >= 2


def _push(queue, new):
    """The queue with its oldest frame dropped and ``new`` ((b, 1, ...)
    or (b, ...)) at the tail; a missing ``new`` leaves it as it is."""
    if new is None or not _is_queue(queue):
        return queue
    new = new[:, :1] if new.ndim == queue.ndim else new[:, None]
    return torch.cat([queue[:, 1:], new.to(queue.dtype)], 1)


@register(
    "StreamingCTSDPipeline",
    aliases=("dwm.pipelines.ctsd.StreamingCrossviewTemporalSD",),
)
class StreamingCTSDPipeline(CTSDPipeline):
    """CTSD plus the FIFO streaming protocol. ``inference_config`` needs
    ``inference_steps`` divisible by the window length; it may set
    ``guidance_scale``, ``sequential_cfg`` (the two CFG branches as two
    b-sized passes instead of one 2b pass) and ``text_prompt_interval``."""

    def steps_per_inference(self, window: int) -> int:
        n = self.inference_config["inference_steps"]
        assert n % window == 0, (
            f"inference_steps {n} must divide by window {window}"
        )
        return n // window

    def splits_stream(self, latent_shape: tuple) -> bool:
        """Whether the data ranks split a stream of the global
        ``latent_shape``: its batch divides by them, and each rank serves
        its rows; else every rank serves the whole stream, as JAX
        replicates a batch that does not divide."""
        n = data_parallel_size(self.mesh)
        return n > 1 and latent_shape[0] % n == 0

    def reset_streaming(
        self, latent_shape: tuple, cond_template: dict,
        generator: Optional[torch.Generator] = None,
        uncond_text: Optional[dict] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> StreamingState:
        """A fresh queue for the global ``latent_shape``: all-noise latents
        (``noise``, else drawn from ``generator``) and zeroed condition
        slots. Where the data ranks split the stream
        (``splits_stream``), the latents are this rank's rows of the
        global noise and ``cond_template`` holds this rank's rows
        (``sharding.shard_batch``)."""
        device = next(self.model.parameters()).device
        split = self.splits_stream(latent_shape)
        if split:
            rows = latent_shape[0] // data_parallel_size(self.mesh)
            latents = self._rank_noise((rows,) + tuple(latent_shape[1:]),
                                       generator, noise)
        elif noise is not None:
            latents = noise.to(device=device, dtype=torch.float32)
        else:
            latents = torch.randn(latent_shape, generator=generator,
                                  device=device)
        conds = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor)
                 else v for k, v in cond_template.items()}
        return StreamingState(latents=latents, conditions=conds,
                              frames_received=0, generator=generator,
                              uncond_text=uncond_text, split=split)

    def send_frame_condition(self, state: StreamingState,
                             frame_batch: dict) -> StreamingState:
        """Push one frame's conditions (single-frame (b, 1, v, ...)
        tensors under the training batch's keys) to the queue's tail.
        Text refreshes only every ``text_prompt_interval`` frames; in
        between, the previous tail text is carried forward."""
        frame_conds = get_conditions(frame_batch, self.common_config)
        interval = int(self.inference_config.get("text_prompt_interval", 1))
        refresh = interval <= 1 or state.frames_received % interval == 0
        new_conds = {}
        for key, q in state.conditions.items():
            new = frame_conds.get(key)
            if key in _TEXT_KEYS and not refresh and new is not None and \
                    _is_queue(q):
                new = q[:, -1:]
            new_conds[key] = _push(q, new)

        uncond_text = state.uncond_text
        new_uncond = {k: frame_batch[f"uncond_{k}"] for k in _TEXT_KEYS
                      if f"uncond_{k}" in frame_batch}
        if new_uncond:
            uncond_text = dict(uncond_text or {}, **new_uncond)
        return dataclasses.replace(
            state, conditions=new_conds,
            frames_received=state.frames_received + 1,
            uncond_text=uncond_text)

    def _guidance_conditions(self, state: StreamingState, sequential: bool):
        """(conds, uncond_conds) of the model calls. The unconditional
        branch per key, as ``get_conditions`` builds it under CFG: layout
        images at ``uncondition_image_color``, action ids at -1000 (the
        other ids pass), text from the provided uncond embeddings (else
        zeros), everything else passes. Batched CFG puts it first in one
        2b batch and returns no ``uncond_conds``."""
        conds = dict(state.conditions)
        uncond_color = self.common_config.get("uncondition_image_color", 0.0)
        added_mode = self.common_config.get("added_time_ids")
        uncond_text = state.uncond_text or {}
        uncond_conds = {}
        for k, q in conds.items():
            if not isinstance(q, torch.Tensor):
                uncond_conds[k] = q
                continue
            if k == "condition_image_tensor":
                uncond = torch.full_like(q, uncond_color)
            elif k == "added_time_ids" and \
                    added_mode == "fps_camera_transforms_action":
                uncond = torch.cat(
                    [q[..., :-2], torch.full_like(q[..., -2:], -1000.0)], -1)
            elif k in _TEXT_KEYS:
                u = uncond_text.get(k)
                uncond = torch.zeros_like(q) if u is None else \
                    u.to(q.dtype).expand(q.shape)
            else:
                uncond = q
            uncond_conds[k] = uncond
        if sequential:
            return conds, uncond_conds
        return {k: torch.cat([uncond_conds[k], q]) if
                isinstance(q, torch.Tensor) else q
                for k, q in conds.items()}, None

    @torch.no_grad()
    def step_stream(self, state: StreamingState,
                    fresh_noise: Optional[torch.Tensor] = None):
        """Advance the window by one frame's worth of denoise steps and
        emit the completed (oldest) frame's latent. ``fresh_noise``: the
        (b, 1, v, h, w, c) tail noise (of the global batch where the
        stream is split), else drawn from the state's generator. Returns (new_state, output (b, v, h, w, c), ready);
        ``ready`` is False while the queue fills (fewer conditions than
        the window)."""
        latents = state.latents
        b, T, v = latents.shape[:3]
        device = latents.device
        spi = self.steps_per_inference(T)
        ic = self.inference_config
        n_steps = ic["inference_steps"]
        sched = self.test_scheduler
        ts_table = torch.as_tensor(sched.inference_timesteps(n_steps),
                                   device=device)
        guidance = ic.get("guidance_scale", 1.0)
        do_cfg = "guidance_scale" in ic
        sequential = do_cfg and bool(ic.get("sequential_cfg", False))

        if do_cfg:
            conds, uncond_conds = self._guidance_conditions(state, sequential)
        else:
            conds, uncond_conds = dict(state.conditions), None
        bb = 2 * b if do_cfg and not sequential else b
        for d in (conds, uncond_conds):
            if d is not None:
                d["disable_crossview"] = torch.zeros(bb, dtype=torch.bool,
                                                     device=device)
                d["disable_temporal"] = torch.zeros(bb, dtype=torch.bool,
                                                    device=device)

        frames = torch.arange(T, device=device)
        for s in range(spi):
            # frame j sits at ladder position (T - 1 - j) * spi + s
            pos = (T - 1 - frames) * spi + s
            step_indices = pos[None, :, None].expand(b, T, v)
            timesteps = ts_table[step_indices.clamp(0, n_steps - 1)]
            if sequential:
                uncond = self.model(sample=latents, timestep=timesteps,
                                    **uncond_conds)
                cond = self.model(sample=latents, timestep=timesteps, **conds)
                pred = uncond + guidance * (cond - uncond)
            elif do_cfg:
                pred = self.model(sample=torch.cat([latents, latents]),
                                  timestep=torch.cat([timesteps, timesteps]),
                                  **conds)
                uncond, cond = pred.chunk(2)
                pred = uncond + guidance * (cond - uncond)
            else:
                pred = self.model(sample=latents, timestep=timesteps, **conds)
            latents = sched.step_by_indices(pred, step_indices, latents,
                                            n_steps)

        output = latents[:, 0]
        if state.split:  # this rank's rows of the global tail noise
            fresh_noise = self.rank_rows(fresh_noise, b) \
                if fresh_noise is not None else self.rank_draws(
                    lambda m: torch.randn(
                        (m, 1) + tuple(latents.shape[2:]),
                        generator=state.generator, device=device,
                        dtype=latents.dtype), b)
        elif fresh_noise is None:
            fresh_noise = torch.randn((b, 1) + tuple(latents.shape[2:]),
                                      generator=state.generator,
                                      device=device, dtype=latents.dtype)
        latents = torch.cat(
            [latents[:, 1:], fresh_noise.to(device=device,
                                            dtype=latents.dtype)], 1)
        ready = state.frames_received >= T
        return dataclasses.replace(state, latents=latents), output, ready

    def receive_frame(self, state: StreamingState,
                      fresh_noise: Optional[torch.Tensor] = None):
        """One queue step per tick, after ``send_frame_condition`` (the
        streaming CLI's cadence)."""
        return self.step_stream(state, fresh_noise)
