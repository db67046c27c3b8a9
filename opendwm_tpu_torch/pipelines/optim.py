"""Optimizer and LR schedules of the training step, in PyTorch.

The counterpart of ``opendwm_tpu/pipelines/optim.py`` (and of
``parallel/flat_optim.py``, the same AdamW math over one buffer): the same
config shapes build the same update.

- AdamW is ``torch.optim.AdamW`` (``fused=True`` on CUDA: the foreach path
  allocates a full-size temporary next to the moments), its moments in the
  parameters' dtype, as ``optax.adamw`` keeps them. The JAX package runs
  its AdamW in XLA, not in a Pallas kernel, so torch's own is the
  counterpart. With ``flat`` and a ``mu_dtype`` other than fp32 (bf16
  moments halve their 8 bytes a parameter), ``FlatAdamW`` follows
  ``flat_adamw``: the math in fp32 on the upcast moments, both moments
  stored in ``mu_dtype``.
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
from torch.distributed.tensor import DTensor

from opendwm_tpu_torch.config import register
from opendwm_tpu_torch.convert import flax_param_name
from opendwm_tpu_torch.parallel.sharding import local


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


class FlatAdamW(torch.optim.Optimizer):
    """``flat_adamw`` (``opendwm_tpu/parallel/flat_optim.py``) with moments
    stored in ``mu_dtype``: per update, in fp32 on the upcast moments,

        mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g g
        step = mu / (1 - b1^c) / (sqrt(nu / (1 - b2^c)) + eps) + wd p
        p += (-lr step) cast to p's dtype

    with c the count after the increment; the moments are then rounded to
    ``mu_dtype``. A parameter without a gradient takes a zero one, as the
    flat buffer does. The update runs on chunks of at most ``CHUNK``
    elements with ``torch._foreach_*`` ops, so the fp32 copies of the
    moments never exist for all parameters at once. Under FSDP the
    parameters, gradients and moments are DTensors: the update, elementwise,
    runs on each rank's local shards."""

    CHUNK = 1 << 26  # 64 Mi elements: ~2 GB of fp32 temporaries a chunk

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    def _chunks(self, params):
        part, size = [], 0
        for p in params:
            if part and size + p.numel() > self.CHUNK:
                yield part
                part, size = [], 0
            part.append(p)
            size += p.numel()
        if part:
            yield part

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FlatAdamW takes no closure")
        for group in self.param_groups:
            lr, (b1, b2) = group["lr"], group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            for params in self._chunks(group["params"]):
                for p in params:
                    state = self.state[p]
                    if not state:
                        state["step"] = 0
                        state["exp_avg"] = torch.zeros_like(
                            p, dtype=self.mu_dtype)
                        state["exp_avg_sq"] = torch.zeros_like(
                            p, dtype=self.mu_dtype)
                    state["step"] += 1
                states = [self.state[p] for p in params]
                # the bias corrections in fp32, as jnp evaluates them
                c = torch.tensor(float(states[0]["step"]))
                bc1 = float(1.0 - torch.tensor(b1) ** c)
                bc2 = float(1.0 - torch.tensor(b2) ** c)
                g = [torch.zeros_like(local(p), dtype=torch.float32)
                     if p.grad is None else local(p.grad).float()
                     for p in params]
                mu = torch._foreach_mul(
                    [local(s["exp_avg"]).float() for s in states], b1)
                torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
                nu = torch._foreach_mul(
                    [local(s["exp_avg_sq"]).float() for s in states], b2)
                g2 = torch._foreach_mul(g, 1.0 - b2)
                torch._foreach_mul_(g2, g)
                torch._foreach_add_(nu, g2)
                del g, g2
                denom = torch._foreach_div(nu, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, eps)
                step = torch._foreach_div(mu, bc1)
                torch._foreach_div_(step, denom)
                del denom
                decay = torch._foreach_mul([local(p).float() for p in params],
                                           wd)
                torch._foreach_add_(step, decay)
                del decay
                torch._foreach_mul_(step, -lr)
                for p, s, m, n, u in zip(params, states, mu, nu, step):
                    local(p).add_(u.to(p.dtype))
                    local(s["exp_avg"]).copy_(m)
                    local(s["exp_avg_sq"]).copy_(n)
        return None

    def load_state_dict(self, state_dict: dict) -> None:
        """``torch.optim.Optimizer.load_state_dict`` casts the moments to
        the parameters' dtype; they go back to ``mu_dtype``."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = state[key].to(self.mu_dtype)


def _dtype(name) -> Optional[torch.dtype]:
    """A ``mu_dtype`` as the configs spell it (``"bfloat16"``,
    ``"jnp.bfloat16"``, a torch dtype) → the torch dtype; None stays None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name).rsplit(".", 1)[-1])


def build_optimizer(params: Sequence[torch.nn.Parameter],
                    optimizer_config: Optional[dict],
                    lr_scheduler_config: Optional[dict] = None):
    """AdamW over ``params`` and its ``LambdaLR`` schedule. With ``flat``
    the moments are kept in ``mu_dtype`` (default fp32; ``FlatAdamW`` for
    any other dtype, torch's fused AdamW for fp32); without it, as the JAX
    package hands ``optax.adamw`` no ``mu_dtype``, in the parameters'."""
    oc = optimizer_config or {}
    params = list(params)
    schedule = build_schedule(lr_scheduler_config or oc.get("lr_scheduler"),
                              oc.get("lr", 1e-4))
    kwargs = dict(lr=1.0, betas=(oc.get("beta1", 0.9), oc.get("beta2", 0.999)),
                  eps=oc.get("eps", 1e-8),
                  weight_decay=oc.get("weight_decay", 0.01))
    mu_dtype = _dtype(oc.get("mu_dtype", "float32")) if oc.get("flat") \
        else None
    if mu_dtype not in (None, torch.float32):
        optimizer = FlatAdamW(params, mu_dtype=mu_dtype, **kwargs)
    else:
        optimizer = torch.optim.AdamW(
            params, fused=bool(params) and all(p.is_cuda for p in params),
            **kwargs)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all the tensors (``optax.global_norm``), fp32; over
    every shard where they are DTensors (FSDP's sharded gradients)."""
    tensors = list(tensors)
    if any(isinstance(t, DTensor) for t in tensors):
        norm = torch.nn.utils.get_total_norm(tensors, 2.0)
        return norm.full_tensor() if isinstance(norm, DTensor) else norm
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
    step, schedule step. Returns whether the parameters were updated.
    Under FSDP the gradients are DTensors: the clip's norm is the global
    norm over every shard (``optax.clip_by_global_norm``), and the
    accumulator's running mean is taken shard by shard on gradients FSDP
    has already averaged once."""
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
