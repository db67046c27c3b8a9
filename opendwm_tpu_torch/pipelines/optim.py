"""Optimizer and LR schedules of the training step, in PyTorch.

The counterpart of ``opendwm_tpu/pipelines/optim.py`` (and of
``parallel/flat_optim.py``, the same AdamW math over one buffer): the same
config shapes build the same update.

- AdamW is ``torch.optim.AdamW`` (``fused=True`` on CUDA: the foreach path
  allocates a full-size temporary next to the moments). The JAX package
  runs its AdamW in XLA, not in a Pallas kernel, so torch's own is the
  counterpart. Moments are fp32; another ``mu_dtype`` is not ported.
- Schedules are functions of the update count, evaluated before it is
  incremented (the first update uses ``schedule(0)``), as optax does; they
  drive the optimizer through a ``LambdaLR`` over a base lr of 1.
- ``freezing_pattern`` (a regex over the JAX package's parameter names,
  ``convert.flax_param_name``): frozen parameters get no optimizer state,
  no decay and no update, and clipping sees only the trainable ones, as
  ``optax.multi_transform`` with ``set_to_zero`` does.
- ``gradient_accumulation_steps`` k: the running mean of k micro-steps'
  gradients is applied every k-th step, as ``optax.MultiSteps`` does.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Optional, Sequence

import torch

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.convert import flax_param_name


# The reference names its schedules by torch class; as in the JAX package
# they resolve to spec dicts that ``build_schedule`` reads.

@register(aliases=("torch.optim.lr_scheduler.CosineAnnealingLR",))
def CosineAnnealingLR(**kwargs):
    return {"type": "cosine", **kwargs}


@register(aliases=("torch.optim.lr_scheduler.ExponentialLR",))
def ExponentialLR(**kwargs):
    return {"type": "exponential", **kwargs}


@register(aliases=("torch.optim.lr_scheduler.LinearLR",))
def LinearLR(**kwargs):
    return {"type": "linear", **kwargs}


def _cosine(init: float, decay_steps: int, alpha: float):
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _linear(init: float, end: float, steps: int):
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def build_schedule(config: Optional[dict], base_lr: float
                   ) -> Callable[[int], float]:
    """lr_scheduler config → lr as a function of the update count
    (``optim.build_schedule`` of the JAX package, optax's formulas)."""
    if not config:
        return lambda count: base_lr
    name = config.get("_class_name", config.get("type", ""))
    name = name.rsplit(".", 1)[-1]
    if name in ("CosineAnnealingLR", "cosine"):
        t_max = config.get("T_max", config.get("decay_steps", 10000))
        eta_min = config.get("eta_min", config.get("end_lr", 0.0))
        return _cosine(base_lr, t_max, eta_min / base_lr if base_lr else 0.0)
    if name in ("ExponentialLR", "exponential"):
        gamma = config.get("gamma", 1.0)
        return lambda count: base_lr * gamma ** count
    if name in ("LinearLR", "linear"):
        start = config.get("start_factor", 1.0 / 3.0)
        end = config.get("end_factor", 1.0)
        return _linear(base_lr * start, base_lr * end,
                       config.get("total_iters", 5))
    if name in ("warmup_cosine", "WarmupCosine"):
        warmup = config.get("warmup_steps", 1000)
        end_lr = config.get("end_lr", 0.0)
        warm = _linear(config.get("init_lr", 0.0), base_lr, warmup)
        decay = _cosine(base_lr, config.get("decay_steps", 100000) - warmup,
                        end_lr / base_lr if base_lr else 0.0)
        return lambda count: warm(count) if count < warmup \
            else decay(count - warmup)
    raise ValueError(f"unknown lr scheduler {name!r}")


def split_trainable(model: torch.nn.Module, pattern: Optional[str]):
    """(trainable, frozen) parameter lists; a parameter is frozen when
    ``pattern`` matches the start of its JAX package name."""
    rx = re.compile(pattern) if pattern else None
    trainable, frozen = [], []
    for name, p in model.named_parameters():
        if rx is not None and rx.match(flax_param_name(name, p.ndim)):
            frozen.append(p)
        else:
            trainable.append(p)
    return trainable, frozen


def build_optimizer(params: Sequence[torch.nn.Parameter],
                    optimizer_config: Optional[dict],
                    lr_scheduler_config: Optional[dict] = None):
    """AdamW over ``params`` and its ``LambdaLR`` schedule."""
    oc = optimizer_config or {}
    mu_dtype = oc.get("mu_dtype", "float32")
    if mu_dtype not in (None, "float32", "jnp.float32", torch.float32):
        raise NotImplementedError(
            f"mu_dtype={mu_dtype!r}: AdamW moments other than fp32 are not "
            "ported yet (ROADMAP Queue 1, item 15)")
    params = list(params)
    schedule = build_schedule(lr_scheduler_config or oc.get("lr_scheduler"),
                              oc.get("lr", 1e-4))
    optimizer = torch.optim.AdamW(
        params, lr=1.0, betas=(oc.get("beta1", 0.9), oc.get("beta2", 0.999)),
        eps=oc.get("eps", 1e-8), weight_decay=oc.get("weight_decay", 0.01),
        fused=bool(params) and all(p.is_cuda for p in params),
    )
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all the tensors (``optax.global_norm``), fp32."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors]
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))


def apply_gradients(optimizer, lr_scheduler,
                    accumulator: Optional["GradientAccumulator"] = None,
                    max_norm: Optional[float] = None) -> bool:
    """The update of the JAX package's optimizer chain from the ``.grad``
    of the optimizer's (trainable) parameters: accumulate (with an
    accumulator, every k-th call goes on), clip to ``max_norm``, AdamW
    step, schedule step. Returns whether the parameters were updated."""
    trainable = [p for group in optimizer.param_groups
                 for p in group["params"]]
    if accumulator is not None and not accumulator.add(trainable):
        return False
    if max_norm:
        torch.nn.utils.clip_grad_norm_(
            [p for p in trainable if p.grad is not None], max_norm)
    optimizer.step()
    lr_scheduler.step()
    return True


class GradientAccumulator:
    """``optax.MultiSteps``: the running mean ``acc + (g - acc) / (n + 1)``
    of ``every_k`` micro-steps' gradients, released every k-th step."""

    def __init__(self, every_k: int):
        self.every_k = every_k
        self.mini_step = 0
        self.acc: Optional[list] = None

    def add(self, params: Sequence[torch.nn.Parameter]) -> bool:
        """Fold the params' ``.grad`` into the mean; on the k-th call put
        the mean into ``.grad`` and return True."""
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in params]
        n = self.mini_step
        for p, acc in zip(params, self.acc):
            if p.grad is None:
                acc.sub_(acc / (n + 1))
            else:
                acc.add_((p.grad - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        for p, acc in zip(params, self.acc):
            p.grad = acc.clone()
            acc.zero_()
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.mini_step = state["mini_step"]
        if state["acc"] is None:
            self.acc = None
        else:
            if self.acc is None:
                self.acc = [torch.empty_like(a) for a in state["acc"]]
            for dst, src in zip(self.acc, state["acc"]):
                dst.copy_(src)
