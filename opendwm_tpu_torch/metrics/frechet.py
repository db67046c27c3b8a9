"""Streaming Fréchet distance, the core of FID and FVD
(``opendwm_tpu/metrics/frechet.py``).

The state is the feature sums, the sums of feature outer products and the
counts, real and fake apart; ``update`` adds a batch of features on their
device, ``compute`` forms means and covariances and the eigenvalue-based
distance on the host in float64.

The JAX package asks for float64 sums (``frechet.py:91-110``), but it never
enables x64, so JAX hands it float32: its sums and covariance sums are
fp32. The port keeps them fp32 too, as that package computes them; the
host step widens them to float64 first.

The feature extractors are pluggable: ``models/inception.py``
(``FIDInceptionV3``) for FID, ``models/i3d.py`` (``InceptionI3d``) for FVD;
``FrechetPairedMetric``'s default is a cheap per-image channel mean and
standard deviation, for smoke evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.metrics.general import merge_states


@dataclasses.dataclass
class FrechetState:
    real_sum: torch.Tensor
    real_cov_sum: torch.Tensor
    real_n: int
    fake_sum: torch.Tensor
    fake_cov_sum: torch.Tensor
    fake_n: int


def _fields(state: FrechetState) -> dict:
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)}


def _frechet_from_stats(mu1, sigma1, mu2, sigma2, shrinkage=0.0) -> float:
    """The Fréchet distance of two Gaussians (numpy, float64). With
    ``shrinkage``, ``eps·I`` is added to both covariances first, so that the
    rank-deficient covariances of fewer samples than features give real,
    nonnegative eigenvalues of their product (``frechet.py:39-59``)."""
    if shrinkage:
        k = sigma1.shape[0]
        sigma1 = sigma1 + shrinkage * np.eye(k)
        sigma2 = sigma2 + shrinkage * np.eye(k)
    a = float(np.sum((mu1 - mu2) ** 2))
    b = float(np.trace(sigma1) + np.trace(sigma2))
    eig = np.linalg.eigvals(sigma1 @ sigma2)
    c = float(np.sum(np.sqrt(eig.astype(np.complex128)).real))
    return a + b - 2 * c


def frechet_distance(real_feats: np.ndarray, fake_feats: np.ndarray) -> float:
    """One-shot Fréchet distance between two feature sets (n, k)."""
    mu1, mu2 = real_feats.mean(0), fake_feats.mean(0)
    s1 = np.cov(real_feats, rowvar=False)
    s2 = np.cov(fake_feats, rowvar=False)
    return _frechet_from_stats(mu1, s1, mu2, s2)


@register("FrechetDistance")
class FrechetDistance:
    """Streaming FID/FVD with an optional feature extractor:

        m = FrechetDistance(dim)
        state = m.init()
        state = m.update(state, feats, real=True)   # on the features' device
        value = m.compute(state)                     # host, float64
    """

    def __init__(self, num_features: int,
                 feature_fn: Optional[Callable] = None,
                 shrinkage: float = 0.0):
        self.dim = num_features
        self.feature_fn = feature_fn
        self.shrinkage = shrinkage

    def init(self, device=None) -> FrechetState:
        k = self.dim

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return FrechetState(real_sum=z(k), real_cov_sum=z(k, k), real_n=0,
                            fake_sum=z(k), fake_cov_sum=z(k, k), fake_n=0)

    def update(self, state: FrechetState, inputs, real: bool) -> FrechetState:
        feats = self.feature_fn(inputs) if self.feature_fn is not None \
            else inputs
        feats = torch.as_tensor(feats).to(torch.float32)
        s, cov = feats.sum(0), feats.T @ feats
        n = feats.shape[0]
        side = "real" if real else "fake"
        return dataclasses.replace(state, **{
            f"{side}_sum": getattr(state, f"{side}_sum").to(s.device) + s,
            f"{side}_cov_sum":
                getattr(state, f"{side}_cov_sum").to(s.device) + cov,
            f"{side}_n": getattr(state, f"{side}_n") + n})

    @staticmethod
    def merge(states: list, batches: int = 1) -> FrechetState:
        """The state after every rank's features from each rank's state
        (data-rank order): the sums added in rank order, in fp32 on the
        first rank's device, and the counts (``merge_states``)."""
        return FrechetState(**merge_states(
            [_fields(s) if isinstance(s, FrechetState) else s
             for s in states], batches))

    def compute(self, state: FrechetState) -> float:
        rn, fn_ = state.real_n, state.fake_n
        if rn < 2 or fn_ < 2:
            raise RuntimeError(
                "Need >=2 real and fake samples to compute Fréchet distance")

        def host(t):
            return t.detach().cpu().double().numpy()

        mu_r = host(state.real_sum) / rn
        mu_f = host(state.fake_sum) / fn_
        cov_r = (host(state.real_cov_sum) - rn * np.outer(mu_r, mu_r)) \
            / (rn - 1)
        cov_f = (host(state.fake_cov_sum) - fn_ * np.outer(mu_f, mu_f)) \
            / (fn_ - 1)
        return _frechet_from_stats(mu_r, cov_r, mu_f, cov_f,
                                   shrinkage=self.shrinkage)


@register("FrechetPairedMetric")
class FrechetPairedMetric:
    """``update(real, fake)`` / ``compute()`` / ``reset()`` around
    ``FrechetDistance``, the protocol ``evaluate_pipeline`` drives.
    ``feature_fn`` maps (..., H, W, C) media to (n, num_features)
    features; the default, each image's channel means and population
    standard deviations (``jnp.std``'s), is a cheap distributional proxy."""

    def __init__(self, num_features: int,
                 feature_fn: Optional[Callable] = None,
                 shrinkage: float = 0.0):
        self._metric = FrechetDistance(
            num_features, feature_fn or self._default_features,
            shrinkage=shrinkage)
        self.num_features = num_features
        self.reset()

    def _default_features(self, x):
        x = torch.as_tensor(x)
        flat = x.reshape((-1,) + tuple(x.shape[-3:]))  # (n, H, W, C)
        feats = torch.cat([flat.mean((1, 2)),
                           flat.std((1, 2), correction=0)], -1)
        return feats[:, : self.num_features]

    def reset(self):
        self.state = self._metric.init()

    def update(self, real, fake):
        self.state = self._metric.update(self.state, real, real=True)
        self.state = self._metric.update(self.state, fake, real=False)

    def compute(self) -> float:
        return self._metric.compute(self.state)

    def state_dict(self) -> dict:
        return _fields(self.state)

    def merge(self, states: list, batches: int = 1) -> None:
        """The state of one instance fed every rank's frames
        (``FrechetDistance.merge``)."""
        self.state = self._metric.merge(states, batches)
