"""DDPM noise schedule with per-element (b, t, v) timestep tensors
(``opendwm_tpu/schedulers/ddpm.py``).

The reference extends diffusers' DDPMScheduler so that ``add_noise`` and
``get_velocity`` broadcast per-(batch, frame, view) timesteps (reference
src/dwm/schedulers/temporal_independent.py:6-45). The tables are numpy
constants (float64 schedule, stored in float32 as the JAX package stores
them); every method gathers from them with integer timestep tensors on
the caller's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from opendwm_tpu_torch.config import register


def make_beta_schedule(schedule: str, num_timesteps: int, beta_start: float,
                       beta_end: float) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_timesteps,
                           dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_timesteps,
                           dtype=np.float64) ** 2
    if schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.array([
            min(1 - alpha_bar((i + 1) / num_timesteps)
                / alpha_bar(i / num_timesteps), 0.999)
            for i in range(num_timesteps)
        ], dtype=np.float64)
    raise ValueError(f"Unknown beta schedule {schedule!r}")


def _index(timesteps, like: torch.Tensor) -> torch.Tensor:
    """Integer timesteps on ``like``'s device (a float index is refused, as
    JAX refuses it)."""
    t = torch.as_tensor(timesteps, device=like.device)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"timesteps index the schedule tables and must be "
                        f"integers, got {t.dtype}")
    return t.long()


def _expand(timesteps: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Right-pad timestep dims so table gathers broadcast over ``like``."""
    while timesteps.ndim < like.ndim:
        timesteps = timesteps[..., None]
    return timesteps


@register(
    "DDPMScheduler",
    aliases=(
        "dwm.schedulers.temporal_independent.DDPMScheduler",
        "diffusers.DDPMScheduler",
    ),
)
@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    variance_type: str = "fixed_small"
    timestep_spacing: str = "leading"
    steps_offset: int = 0

    def __post_init__(self):
        betas = make_beta_schedule(self.beta_schedule,
                                   self.num_train_timesteps, self.beta_start,
                                   self.beta_end)
        object.__setattr__(self, "betas", betas.astype(np.float32))
        object.__setattr__(self, "alphas_cumprod",
                           np.cumprod(1.0 - betas).astype(np.float32))

    def _ac(self, t: torch.Tensor) -> torch.Tensor:
        """``alphas_cumprod[t]`` (fp32, on ``t``'s device)."""
        return torch.as_tensor(self.alphas_cumprod, device=t.device)[t]

    # -- training ------------------------------------------------------------

    def draw_train_timesteps(self, shape, generator=None, device=None):
        """Integer timesteps uniform on ``[0, num_train_timesteps)``, the
        distribution of the JAX package's ``jax.random.randint`` draw
        (``opendwm_tpu/pipelines/ctsd.py:569``), from ``generator``."""
        return torch.randint(0, self.num_train_timesteps, tuple(shape),
                             generator=generator, device=device)

    def add_noise(self, original, noise, timesteps):
        ac = self._ac(_expand(_index(timesteps, original), original))
        ac = ac.to(original.dtype)
        return ac**0.5 * original + (1 - ac) ** 0.5 * noise

    def get_velocity(self, sample, noise, timesteps):
        ac = self._ac(_expand(_index(timesteps, sample), sample))
        ac = ac.to(sample.dtype)
        return ac**0.5 * noise - (1 - ac) ** 0.5 * sample

    def pred_original(self, model_output, sample, timesteps):
        """x0 from the model output under this prediction type (fp32)."""
        ac = self._ac(_expand(_index(timesteps, sample), sample))
        sample, model_output = sample.float(), model_output.float()
        if self.prediction_type == "epsilon":
            return (sample - (1 - ac) ** 0.5 * model_output) / ac**0.5
        if self.prediction_type == "sample":
            return model_output
        if self.prediction_type == "v_prediction":
            return ac**0.5 * sample - (1 - ac) ** 0.5 * model_output
        raise ValueError(self.prediction_type)

    def training_target(self, original, noise, timesteps):
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "sample":
            return original
        if self.prediction_type == "v_prediction":
            return self.get_velocity(original, noise, timesteps)
        raise ValueError(self.prediction_type)

    # -- ancestral sampling --------------------------------------------------

    def step(self, model_output, timesteps, sample, noise):
        """One ancestral DDPM step at (possibly per-element) ``timesteps``;
        ``noise`` is explicit and masked out at t == 0. The result keeps the
        sample's dtype."""
        t = _expand(_index(timesteps, sample), sample)
        ac_t = self._ac(t)
        ac_prev = torch.where(t > 0, self._ac((t - 1).clamp(min=0)), 1.0)
        alpha_t = ac_t / ac_prev
        beta_t = 1 - alpha_t

        x0 = self.pred_original(model_output, sample, timesteps)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)

        coef_x0 = ac_prev**0.5 * beta_t / (1 - ac_t)
        coef_xt = alpha_t**0.5 * (1 - ac_prev) / (1 - ac_t)
        mean = coef_x0 * x0 + coef_xt * sample.float()

        var = ((1 - ac_prev) / (1 - ac_t) * beta_t).clamp(min=1e-20)
        std = torch.where(t > 0, var**0.5, 0.0)
        return (mean + std * noise.float()).to(sample.dtype)
