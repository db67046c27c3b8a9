"""LiDAR VQ-VAE trainer (``opendwm_tpu/pipelines/lidar_vqvae.py``), in
PyTorch.

The loss is the stabilised voxel BCE, the DVGO depth soft-L1 and free-space
(SDF) terms and the quantizer's (commitment, codebook) pair, each weighted
by the training config; AdamW with the config's clipping. Codebook health
lives in the train state: each step updates the code ages and usage from
the step's indices and refreshes a reservoir of ``n_e · 10`` quantized
features (1% rolled a step, or filled whole on the first step);
``maybe_revive_codebook`` is the explicit host-side k-means revival the
JAX package offers between steps (its train CLI never calls it, nor does
the port's).

The JAX loss encodes the batch a second time only to read ``z_q`` and the
indices without gradient; the port takes both from the one forward (the
same values). The reservoir is filled from ``z_q``, whose values are codes,
not encoder features, as in the JAX package. Its index draws are explicit
(``draw_reservoir``, from a ``torch.Generator``, or given).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from opendwm_tpu_torch.parallel.collectives import gather_batch
from opendwm_tpu_torch.parallel.train_state import MeshPlacement
from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.models.vq_point_cloud import (
    kmeans_revive,
    update_code_stats,
)
from opendwm_tpu_torch.pipelines import optim
from opendwm_tpu_torch.pipelines.ctsd import (
    TrainState,
    build_train_state,
)


def stable_bce_with_logits(logits: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean BCE of logits against 0/1 targets."""
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


@dataclasses.dataclass
class VQTrainState(TrainState):
    """``TrainState`` with the codebook's health: the code ages and usage,
    the reservoir and whether it has been filled."""

    code_age: Optional[torch.Tensor] = None
    code_usage: Optional[torch.Tensor] = None
    reservoir: Optional[torch.Tensor] = None
    reservoir_initialized: bool = False


def optax_gradients(state: TrainState, finite_only: bool = False) -> None:
    """Gradients as optax receives them: a trainable parameter that took
    no gradient gets zeros (so AdamW's decay still moves it, as
    ``optax.adamw`` does); with ``finite_only`` every non-finite entry
    becomes 0."""
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif finite_only:
                p.grad.masked_fill_(~torch.isfinite(p.grad), 0.0)


def step_optimizer(state: TrainState, loss: torch.Tensor,
                   training_config: dict, finite_only: bool = False) -> None:
    """Backward from ``loss``, then the JAX chain's update (clip, AdamW,
    schedule; accumulation) of the trainable parameters."""
    for p in state.model.parameters():
        p.grad = None
    loss.backward()
    optax_gradients(state, finite_only)
    optim.apply_gradients(state.optimizer, state.lr_scheduler,
                          state.accumulator,
                          training_config.get("max_norm_for_grad_clip"))
    for p in state.model.parameters():
        p.grad = None


@register(
    "LidarCodebook", aliases=("dwm.pipelines.lidar_vqvae.LidarCodebook",)
)
class LidarCodebook(MeshPlacement):
    """The VQ tokenizer's trainer. ``mesh`` and ``sharding_policy``
    (default ``"ddp"``, as JAX's) place the train state over a process
    group (``parallel.train_state.MeshPlacement``); the codebook's health
    is then updated from every rank's codes (all-gathered), so it is the
    same on every rank and equals the global batch's."""

    def __init__(self, vq_point_cloud, common_config: Optional[dict] = None,
                 training_config: Optional[dict] = None,
                 optimizer_config: Optional[dict] = None,
                 lr_scheduler_config: Optional[dict] = None, mesh=None,
                 sharding_policy: Optional[str] = None,
                 sharding_min_size: Optional[int] = None):
        self.model = vq_point_cloud
        self.common_config = common_config or {}
        self.training_config = training_config or {}
        self.optimizer_config = optimizer_config
        self.lr_scheduler_config = lr_scheduler_config
        self._set_mesh(mesh, sharding_policy or "ddp", sharding_min_size)

    def init_state(self) -> VQTrainState:
        """The train state on the model's device: code ages at 10000,
        zero usage, an empty reservoir of ``n_e · 10`` rows."""
        vq = self.model.vector_quantizer
        dev = vq.embedding.device
        return self.shard_state(build_train_state(
            self.model, self.training_config, self.optimizer_config,
            self.lr_scheduler_config, VQTrainState,
            code_age=torch.full((vq.n_e,), 10000.0, device=dev),
            code_usage=torch.zeros(vq.n_e, device=dev),
            reservoir=torch.zeros(vq.n_e * 10, vq.e_dim, device=dev)))

    def loss_from_draws(self, batch: dict, draws: Optional[dict] = None):
        """(loss, (metrics, z_q without gradient, indices)); the loss
        draws nothing, ``draws`` is the reservoir's."""
        tc = self.training_config
        out = self.model(batch["lidar_points"], batch["lidar_points_mask"])
        voxel_loss = stable_bce_with_logits(
            out["lidar_voxel"].float(), out["voxels"].float()) \
            * tc.get("voxel_loss_coef", 1.0)
        commit, codebook = out["emb_loss"]
        emb_loss = (commit + codebook) * tc.get("emb_loss_coef", 1.0)
        depth_loss = out["depth_loss"] * tc.get("depth_loss_coef", 1.0)
        sdf_loss = out["sdf_loss"] * tc.get("sdf_loss_coef", 1.0)
        loss = voxel_loss + emb_loss + depth_loss + sdf_loss
        metrics = {"loss": loss, "voxel_loss": voxel_loss,
                   "emb_loss": emb_loss, "depth_loss": depth_loss,
                   "sdf_loss": sdf_loss}
        return loss, (metrics, out["z_q"].detach(), out["indices"])

    def loss_fn(self, batch: dict, generator=None):
        return self.loss_from_draws(batch)

    def draw_reservoir(self, rows: int, generator=None,
                       device=None) -> dict:
        """The reservoir's index draws over ``rows`` features: ``take``,
        1% of the reservoir without replacement (the roll), and ``fill``,
        the whole reservoir with replacement (the first step)."""
        size = self.model.vector_quantizer.n_e * 10
        take = torch.randperm(rows, generator=generator,
                              device=device)[:size // 100]
        fill = torch.randint(0, rows, (size,), generator=generator,
                             device=device)
        return {"take": take, "fill": fill}

    @torch.no_grad()
    def update_codebook_health(self, state: VQTrainState,
                               feats: torch.Tensor, idx: torch.Tensor,
                               draws: dict) -> None:
        """Ages and usage from ``idx``; the reservoir rolled by 1% with
        ``feats[draws["take"]]``, or filled with ``feats[draws["fill"]]``
        on the first step."""
        n_e = self.model.vector_quantizer.n_e
        state.code_age, state.code_usage = update_code_stats(
            idx, state.code_age, state.code_usage, n_e)
        flat = feats.reshape(-1, feats.shape[-1]).float()
        res = state.reservoir
        take, fill = (draws[k].to(flat.device) for k in ("take", "fill"))
        if state.reservoir_initialized:
            state.reservoir = torch.cat([res[res.shape[0] // 100:],
                                         flat[take]])
        else:
            state.reservoir = flat[fill]
        state.reservoir_initialized = True

    def train_step(self, state: VQTrainState, batch: dict, generator=None,
                   draws: Optional[dict] = None):
        """One step: loss, gradients, clip and AdamW, then the codebook's
        health. ``draws`` (``draw_reservoir``) replaces the generator's.
        Updates ``state`` in place and returns ``(state, metrics)``."""
        loss, (metrics, feats, idx) = self.loss_from_draws(batch)
        step_optimizer(state, loss, self.training_config)
        if self.distributed:
            feats, idx = gather_batch(feats), gather_batch(idx)
        if draws is None:
            draws = self.draw_reservoir(idx.numel(), generator, idx.device)
        self.update_codebook_health(state, feats, idx, draws)
        state.step += 1
        return state, self.reduce_metrics(
            {k: v.detach() for k, v in metrics.items()})

    @torch.no_grad()
    def maybe_revive_codebook(self, state: VQTrainState, seed: int = 0):
        """Host-side k-means dead-code revival when more than 3% of the
        codes are dead (age ≥ ``dead_limit``): the codebook becomes
        ``kmeans_revive``'s, ages and usage return to 0. Returns (state,
        revived)."""
        vq = self.model.vector_quantizer
        age = state.code_age.cpu().numpy()
        if (age >= vq.dead_limit).sum() / vq.n_e <= 0.03:
            return state, False
        new = kmeans_revive(vq.embedding.detach().cpu().numpy(),
                            state.reservoir.cpu().numpy(), age,
                            vq.dead_limit, seed)
        vq.embedding.copy_(torch.from_numpy(new))
        state.code_age = torch.zeros_like(state.code_age)
        state.code_usage = torch.zeros_like(state.code_usage)
        return state, True
