"""int8 W8A8 serving (``opendwm_tpu/ops/quant.py``), in PyTorch.

The JAX package's scheme, reproduced bit for bit where it is integer:

- weights: symmetric int8 per OUTPUT channel, ``scale = max(amax,
  1e-8) / 127``, ``wq = clip(round(w / scale), -127, 127)`` (round half
  to even), quantized offline from the float checkpoint
  (``quantize_state_dict``);
- dense activations: one scale per token (over the last axis), taken on
  the fly from the input in the dtype it arrives in, cast to fp32;
- conv activations: one scale per TENSOR (the amax of the whole input,
  every image of the batch);
- int32 accumulation, dequantized as ``(y * x_scale * w_scale)`` in fp32,
  in that order, then cast to the output dtype.

Every division is by a tensor, never by a Python number: on the card
PyTorch turns ``t / 127.0`` into a product with the reciprocal, which may
differ from the division in the last bit.

Layouts are the port's: a dense weight is ``(N, K)`` as ``nn.Linear``'s,
a conv weight ``(N, kh, kw, Cin)`` (channel-last, so the im2col rows of
``int8_conv`` are ``(kh, kw, Cin)``-ordered as its K axis). The integer
product (``int8_mm``) is ``torch._int_mm`` on the card (the counterpart of
the JAX package's XLA ``dot_general`` / ``conv_general_dilated`` with an
int32 result, not a hand-written kernel), with K and N padded to multiples
of 8 and the rows past 16 by zero int8, which adds nothing, and the
weight passed as ``(N, K).t()`` (cuBLASLt's int8 "TN" layout). On CPU
tensors it is the plain int32 product; both are exact, so they give the
same integers. Each call on the card adds one to ``launches``.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Union

import torch
import torch.nn.functional as F

launches = 0  # torch._int_mm calls since the last reset
launches_by_shape: dict = {}  # (M, K, N) before padding -> calls

Padding = Union[int, str, Sequence[Sequence[int]]]


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` in fp32, divided by a tensor on
    ``amax``'s device (see the module docstring)."""
    return amax.clamp(min=1e-8) / torch.full((), 127.0, device=amax.device)


def _round_int8(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x32 / scale).round().clamp(-127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, ...)`` float → int8 of the same layout and the fp32 scale
    ``(N,)``, one per OUTPUT channel (the leading axis; the JAX package's
    kernels hold it last)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = _scale(amax)
    return _round_int8(w32, scale.reshape((-1,) + (1,) * (w.ndim - 1))), \
        scale


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., K)`` float → int8 and the fp32 per-row scale ``(..., 1)``."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(dim=-1, keepdim=True))
    return _round_int8(x32, scale), scale


def quantize_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Any float tensor → int8 and one fp32 scale (0-dim) for all of it:
    the conv activations' scale."""
    x32 = x.float()
    scale = _scale(x32.abs().amax())
    return _round_int8(x32, scale), scale


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` in int32: ``a`` ``(M, K)`` and ``w`` ``(N, K)`` int8."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ w.to(torch.int32).t()
    if a.device.type != "cuda":
        raise ValueError(f"int8_mm runs on the card or the CPU, not on "
                         f"{a.device}")
    global launches
    m, k = a.shape
    n = w.shape[0]
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    rows = max(m, 17)  # torch._int_mm takes more than 16 rows
    if (rows, k8) != (m, k):
        a = _pad_to(a, rows, k8)
    if (n8, k8) != (n, k):
        w = _pad_to(w, n8, k8)
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    launches += 1
    launches_by_shape[(m, k, n)] = launches_by_shape.get((m, k, n), 0) + 1
    return y[:m, :n] if (rows, n8) != (m, n) else y


def _dequantize(y: torch.Tensor, x_scale, w_scale,
                out_dtype: torch.dtype) -> torch.Tensor:
    return (y.float() * x_scale * w_scale).to(out_dtype)


def int8_matmul(x: torch.Tensor, weight_q: torch.Tensor,
                weight_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ dequant(weight_q).T`` with int32 accumulation: ``x`` ``(...,
    K)`` float (quantized per token in its own dtype), ``weight_q`` ``(N,
    K)`` int8, ``weight_scale`` ``(N,)`` fp32."""
    xq, x_scale = quantize_activation(x)
    k = x.shape[-1]
    y = int8_mm(xq.reshape(-1, k), weight_q)
    return _dequantize(y, x_scale.reshape(-1, 1), weight_scale,
                       out_dtype).reshape(*x.shape[:-1], -1)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``SAME``: the output has ceil(size / s) positions."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_pads(padding: Padding, hw: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> tuple:
    """``((top, bottom), (left, right))`` of flax's padding forms: an int,
    ``"SAME"``, ``"VALID"`` or explicit pairs."""
    if isinstance(padding, int):
        return ((padding, padding),) * 2
    if isinstance(padding, str):
        form = padding.upper()
        if form == "VALID":
            return ((0, 0),) * 2
        if form == "SAME":
            return tuple(_same_pads(n, k, s)
                         for n, k, s in zip(hw, kernel, strides))
        raise ValueError(f"unknown padding {padding!r}")
    return tuple(tuple(int(p) for p in pair) for pair in padding)


def im2col(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int],
           pads) -> torch.Tensor:
    """Channel-last patches: ``(N, H, W, C)`` → ``(N, Ho, Wo, kh * kw *
    C)``, ``(kh, kw, C)``-ordered, of any dtype (int8 here)."""
    (kh, kw), (sh, sw) = kernel, strides
    (top, bottom), (left, right) = pads
    if (kh, kw, sh, sw, top, bottom, left, right) == (1, 1, 1, 1, 0, 0, 0, 0):
        return x
    x = F.pad(x, (0, 0, left, right, top, bottom))
    ho = (x.shape[1] - kh) // sh + 1
    wo = (x.shape[2] - kw) // sw + 1
    return torch.cat([
        x[:, dy:dy + sh * (ho - 1) + 1:sh, dx:dx + sw * (wo - 1) + 1:sw]
        for dy in range(kh) for dx in range(kw)], dim=-1)


def int8_conv(x: torch.Tensor, weight_q: torch.Tensor,
              weight_scale: torch.Tensor, strides: Sequence[int] = (1, 1),
              padding: Padding = "SAME",
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NHWC conv with int32 accumulation: ``x`` ``(N, H, W, Cin)`` float,
    quantized with one scale for the whole tensor; ``weight_q`` ``(Cout,
    kh, kw, Cin)`` int8; ``weight_scale`` ``(Cout,)`` fp32. im2col and one
    ``int8_mm`` (cuDNN's int8 convolutions are not reachable from
    PyTorch)."""
    cout, kh, kw, cin = weight_q.shape
    pads = conv_pads(padding, x.shape[1:3], (kh, kw), strides)
    xq, scale = quantize_tensor(x)
    cols = im2col(xq, (kh, kw), strides, pads)
    n, ho, wo, k = cols.shape
    y = int8_mm(cols.reshape(-1, k), weight_q.reshape(cout, -1))
    return _dequantize(y, scale, weight_scale, out_dtype).reshape(
        n, ho, wo, cout)


def quantize_state_dict(float_state: Mapping[str, torch.Tensor],
                        qmodel: torch.nn.Module) -> dict:
    """The int8 state dict of ``qmodel`` from the float model's state dict
    (``quantize_param_tree``): wherever ``qmodel`` holds ``weight_q`` and
    ``weight_scale``, the float ``weight`` at the same path is quantized
    per output channel (a conv's ``(N, Cin, kh, kw)`` weight to the
    channel-last ``(N, kh, kw, Cin)`` of ``QConv2d``); every other entry
    (biases, norms, embeddings, float layers) passes through. Only
    ``qmodel``'s structure is read, so it may live on the meta device.
    Raises ``KeyError`` on an entry that one side has and the other has
    not."""
    out: dict = {}
    quantized = set()
    for key in qmodel.state_dict():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "weight_scale":
            continue
        if leaf != "weight_q":
            out[key] = float_state[key]
            continue
        w = float_state[f"{prefix}.weight"]
        if w.ndim == 4:
            w = w.permute(0, 2, 3, 1)
        wq, scale = quantize_weight(w)
        out[key], out[f"{prefix}.weight_scale"] = wq.contiguous(), scale
        quantized.add(f"{prefix}.weight")
    extra = set(float_state) - set(out) - quantized
    if extra:
        raise KeyError(f"entries the int8 model has no place for: "
                       f"{sorted(extra)[:10]}")
    return out
