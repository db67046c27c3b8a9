"""DDIM sampler with per-element timestep tensors
(``opendwm_tpu/schedulers/ddim.py``).

The reference's tensor-timestep DDIM step (src/dwm/schedulers/
temporal_independent.py:48-170): every table lookup is a gather broadcast
over the sample shape. Deterministic (eta = 0) by default; eta > 0 takes
explicit noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.schedulers.ddpm import DDPMScheduler, _expand, _index


@register(
    "DDIMScheduler",
    aliases=(
        "dwm.schedulers.temporal_independent.DDIMScheduler",
        "diffusers.DDIMScheduler",
    ),
)
@dataclasses.dataclass(frozen=True)
class DDIMScheduler(DDPMScheduler):
    set_alpha_to_one: bool = False
    clip_sample: bool = False

    @property
    def final_alpha_cumprod(self) -> float:
        return 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timesteps (leading spacing + offset)."""
        step = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step).round()[::-1]
        return (ts + self.steps_offset).astype(np.int32)

    def step(self, model_output, timesteps, sample,
             num_inference_steps: int, eta: float = 0.0, noise=None):
        """One DDIM step from integer ``timesteps`` (broadcast over the
        sample); the result keeps the sample's dtype."""
        t = _expand(_index(timesteps, sample), sample)
        prev_t = t - self.num_train_timesteps // num_inference_steps
        ac_t = self._ac(t)
        ac_prev = torch.where(prev_t >= 0, self._ac(prev_t.clamp(min=0)),
                              self.final_alpha_cumprod)
        beta_t = 1 - ac_t

        sample32, out32 = sample.float(), model_output.float()
        if self.prediction_type == "epsilon":
            x0 = (sample32 - beta_t**0.5 * out32) / ac_t**0.5
            eps = out32
        elif self.prediction_type == "sample":
            x0 = out32
            eps = (sample32 - ac_t**0.5 * x0) / beta_t**0.5
        elif self.prediction_type == "v_prediction":
            x0 = ac_t**0.5 * sample32 - beta_t**0.5 * out32
            eps = ac_t**0.5 * out32 + beta_t**0.5 * sample32
        else:
            raise ValueError(self.prediction_type)

        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)

        variance = (1 - ac_prev) / beta_t * (1 - ac_t / ac_prev)
        std_dev = eta * variance**0.5
        prev_sample = ac_prev**0.5 * x0 + \
            (1 - ac_prev - std_dev**2) ** 0.5 * eps
        if eta > 0:
            if noise is None:
                raise ValueError("eta > 0 needs explicit noise")
            prev_sample = prev_sample + std_dev * noise.float()
        return prev_sample.to(sample.dtype)
