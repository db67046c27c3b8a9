"""Flow-matching Euler scheduler with per-frame sigma indices
(``opendwm_tpu/schedulers/flow_match.py``).

SD3-style rectified flow: x_sigma = (1 - sigma) x0 + sigma eps; the model
predicts the velocity (eps - x0). ``step_by_indices`` lets diffusion
forcing advance each frame along its own point of the sigma ladder. The
ladders are numpy constants; everything else takes and returns tensors on
the caller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opendwm_tpu_torch.config import register


@register(
    "FlowMatchEulerScheduler",
    aliases=(
        "dwm.schedulers.temporal_independent.FlowMatchEulerDiscreteScheduler",
        "diffusers.FlowMatchEulerDiscreteScheduler",
    ),
)
@dataclasses.dataclass(frozen=True)
class FlowMatchEulerScheduler:
    num_train_timesteps: int = 1000
    shift: float = 3.0

    def _shift_sigma(self, sigma):
        return self.shift * sigma / (1 + (self.shift - 1) * sigma)

    @property
    def train_sigmas(self) -> np.ndarray:
        """Descending per-train-timestep sigmas (index 0 = most noised)."""
        ts = np.arange(1, self.num_train_timesteps + 1, dtype=np.float64)[::-1]
        sigmas = ts / self.num_train_timesteps
        return np.asarray(self._shift_sigma(sigmas), dtype=np.float32)

    def inference_sigmas(self, num_inference_steps: int) -> np.ndarray:
        """Sigma ladder for sampling, with the trailing 0 appended.

        As diffusers 0.31 ``set_timesteps``: the linspace runs over the
        shifted train endpoints and the shift is applied again to the result.
        """
        train = self.train_sigmas.astype(np.float64)
        sigmas = self._shift_sigma(
            np.linspace(train[0], train[-1], num_inference_steps)
        )
        return np.concatenate([sigmas, [0.0]]).astype(np.float32)

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        return (
            self.inference_sigmas(num_inference_steps)[:-1]
            * self.num_train_timesteps
        )

    # -- training ------------------------------------------------------------

    def sample_train_indices(
        self, shape, generator: torch.Generator | None = None,
        device=None, logit_mean: float = 0.0, logit_std: float = 1.0,
        weighting_scheme: str = "logit_normal",
    ) -> torch.Tensor:
        """Draw sigma ladder indices via SD3's logit-normal density."""
        return self.indices_from_draw(
            self.draw_for_indices(shape, generator, device, weighting_scheme),
            logit_mean, logit_std, weighting_scheme)

    @staticmethod
    def draw_for_indices(shape, generator: torch.Generator | None = None,
                         device=None, weighting_scheme: str = "logit_normal"):
        """The random draw behind ``sample_train_indices``: standard normal
        for ``logit_normal``, uniform on [0, 1) for ``uniform``."""
        if weighting_scheme == "logit_normal":
            return torch.randn(shape, generator=generator, device=device)
        if weighting_scheme == "uniform":
            return torch.rand(shape, generator=generator, device=device)
        raise ValueError(weighting_scheme)

    def indices_from_draw(self, draw: torch.Tensor, logit_mean: float = 0.0,
                          logit_std: float = 1.0,
                          weighting_scheme: str = "logit_normal"):
        """Sigma ladder indices from a ``draw_for_indices`` draw (so a test
        can hand in the JAX package's draw)."""
        if weighting_scheme == "logit_normal":
            u = torch.sigmoid(logit_mean + logit_std * draw)
        elif weighting_scheme == "uniform":
            u = draw
        else:
            raise ValueError(weighting_scheme)
        idx = (u * self.num_train_timesteps).to(torch.int64)
        return idx.clamp(0, self.num_train_timesteps - 1)

    def sigmas_at(self, indices: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.train_sigmas,
                               device=indices.device)[indices]

    def timesteps_at(self, indices: torch.Tensor) -> torch.Tensor:
        return self.sigmas_at(indices) * self.num_train_timesteps

    def add_noise(self, original, noise, sigmas):
        while sigmas.ndim < original.ndim:
            sigmas = sigmas[..., None]
        sigmas = sigmas.to(original.dtype)
        return (1.0 - sigmas) * original + sigmas * noise

    def training_target(self, original, noise):
        return noise - original

    # -- sampling --------------------------------------------------------------

    def step_by_indices(self, model_output, step_indices, sample,
                        num_inference_steps: int):
        """Euler update with per-element positions on the inference ladder;
        the result keeps the sample's dtype."""
        sigmas = torch.as_tensor(self.inference_sigmas(num_inference_steps),
                                 device=sample.device)
        idx = torch.as_tensor(step_indices, device=sample.device)
        while idx.ndim < sample.ndim:
            idx = idx[..., None]
        sigma, sigma_next = sigmas[idx], sigmas[idx + 1]
        prev = sample.float() + (sigma_next - sigma) * model_output.float()
        return prev.to(sample.dtype)
