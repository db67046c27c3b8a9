"""Fused AdaLN-modulate: LayerNorm (no affine) + per-sample scale/shift.

Replaces the Pallas kernels of ``opendwm_tpu/ops/fused_adaln.py``:

- ``adaln_modulate`` (``_forward``, body ``_kernel``):
  ``ln(x) * (1 + scale) + shift``;
- ``residual_adaln_modulate`` (``_res_forward``, body ``_res_kernel``):
  ``x' = x + gate * delta`` and ``ln(x') * (1 + scale) + shift``, both
  returned.

x is (n, L, d); scale/shift/gate are (n, d) or (n, 1, d), one vector per
sample. The JAX model writes this chain out in jnp; the port's joint block
calls these kernels at every modulation.

The Hopper kernels are Triton: one program per row, one mean/variance
reduction over d in registers (fp32), then the elementwise epilogue. No
matrix product is involved, so each is bound by device-memory bytes:
one read of x (and delta) and one write of each output, against the
three or more passes of the unfused chain. Triton is imported and the
kernels are JIT-wrapped at the first launch. Backward is autograd of the
plain version, as in the JAX package.

Where the residual form rounds: the kernel normalises the fp32 sum
``x + gate * delta`` (as ``_res_kernel`` does), not the sum rounded to
``x.dtype`` (as ``_res_reference`` does); the plain version follows the
kernel. In fp32 the two agree.
"""

from __future__ import annotations

import torch

launches = 0
res_launches = 0

tl = None  # triton.language, bound at the first launch
_KERNELS = None


def reset_launches() -> None:
    global launches, res_launches
    launches = 0
    res_launches = 0


def _per_sample(t, n: int, d: int):
    if t.shape not in ((n, d), (n, 1, d)):
        raise ValueError(f"modulation must be (n, d) or (n, 1, d); got "
                         f"{tuple(t.shape)} for n={n}, d={d}")
    return t.reshape(n, d)


def _layer_norm_fp32(x32, eps: float):
    mean = x32.mean(-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps)


def adaln_modulate_plain(x, scale, shift, eps: float = 1e-6):
    """Plain PyTorch version (``fused_adaln._reference``)."""
    n, _, d = x.shape
    scale = _per_sample(scale, n, d)[:, None].float()
    shift = _per_sample(shift, n, d)[:, None].float()
    y = _layer_norm_fp32(x.float(), eps)
    return (y * (1.0 + scale) + shift).to(x.dtype)


def residual_adaln_modulate_plain(x, delta, gate, scale, shift,
                                  eps: float = 1e-6):
    """Plain PyTorch version of the residual form, as the kernel rounds."""
    n, _, d = x.shape
    gate = _per_sample(gate, n, d)[:, None].float()
    scale = _per_sample(scale, n, d)[:, None].float()
    shift = _per_sample(shift, n, d)[:, None].float()
    xn = x.float() + gate * delta.float()
    y = _layer_norm_fp32(xn, eps) * (1.0 + scale) + shift
    return xn.to(x.dtype), y.to(x.dtype)


# -- Triton kernels (JIT-wrapped at the first launch) ------------------------

def _adaln_kernel(x_ptr, sc_ptr, sh_ptr, out_ptr, rows_per_sample, d,
                  sc_stride, sh_stride, eps, BLOCK_D: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    sample = row // rows_per_sample
    cols = tl.arange(0, BLOCK_D)
    mask = cols < d
    x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / d
    xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / d
    y = xc / tl.sqrt(var + eps)
    sc = tl.load(sc_ptr + sample * sc_stride + cols, mask=mask,
                 other=0.0).to(tl.float32)
    sh = tl.load(sh_ptr + sample * sh_stride + cols, mask=mask,
                 other=0.0).to(tl.float32)
    out = y * (1.0 + sc) + sh
    tl.store(out_ptr + row * d + cols, out.to(out_ptr.dtype.element_ty),
             mask=mask)


def _res_adaln_kernel(x_ptr, dl_ptr, g_ptr, sc_ptr, sh_ptr, xo_ptr, yo_ptr,
                      rows_per_sample, d, g_stride, sc_stride, sh_stride, eps,
                      BLOCK_D: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    sample = row // rows_per_sample
    cols = tl.arange(0, BLOCK_D)
    mask = cols < d
    x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
    delta = tl.load(dl_ptr + row * d + cols, mask=mask,
                    other=0.0).to(tl.float32)
    g = tl.load(g_ptr + sample * g_stride + cols, mask=mask,
                other=0.0).to(tl.float32)
    xn = x + g * delta
    tl.store(xo_ptr + row * d + cols, xn.to(xo_ptr.dtype.element_ty),
             mask=mask)
    mean = tl.sum(xn, axis=0) / d
    xc = tl.where(mask, xn - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / d
    y = xc / tl.sqrt(var + eps)
    sc = tl.load(sc_ptr + sample * sc_stride + cols, mask=mask,
                 other=0.0).to(tl.float32)
    sh = tl.load(sh_ptr + sample * sh_stride + cols, mask=mask,
                 other=0.0).to(tl.float32)
    out = y * (1.0 + sc) + sh
    tl.store(yo_ptr + row * d + cols, out.to(yo_ptr.dtype.element_ty),
             mask=mask)


def _kernels():
    global tl, _KERNELS
    if _KERNELS is None:
        import triton
        import triton.language

        tl = triton.language
        _KERNELS = (triton.jit(_adaln_kernel), triton.jit(_res_adaln_kernel))
    return _KERNELS


def build() -> None:
    """Import Triton and wrap the kernels now rather than at first launch."""
    _kernels()


def _check_rows(x, *others) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (n, L, d); got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"fused_adaln takes a float x, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_adaln takes a contiguous x")
    for t in others:
        if t.device != x.device:
            raise ValueError("all fused_adaln inputs must lie on one device")


def _vec(t, n: int, d: int):
    t = _per_sample(t, n, d)
    if t.stride(-1) != 1:
        raise ValueError("modulation vectors must be contiguous along d")
    return t


def _launch_config(d: int):
    block = 1 << (d - 1).bit_length()  # next power of two
    return block, max(1, min(16, block // 256))


def _launch_adaln(x, scale, shift, eps):
    global launches
    adaln, _ = _kernels()
    n, l, d = x.shape
    scale, shift = _vec(scale, n, d), _vec(shift, n, d)
    out = torch.empty_like(x)
    block, warps = _launch_config(d)
    with torch.cuda.device(x.device):
        adaln[(n * l,)](x, scale, shift, out, l, d, scale.stride(0),
                        shift.stride(0), eps, BLOCK_D=block, num_warps=warps)
    launches += 1
    return out


def _launch_res_adaln(x, delta, gate, scale, shift, eps):
    global res_launches
    _, res_adaln = _kernels()
    n, l, d = x.shape
    if delta.shape != x.shape or delta.dtype != x.dtype or \
            not delta.is_contiguous():
        raise ValueError("delta must be contiguous, with x's shape and dtype")
    gate, scale, shift = (_vec(t, n, d) for t in (gate, scale, shift))
    xo, yo = torch.empty_like(x), torch.empty_like(x)
    block, warps = _launch_config(d)
    with torch.cuda.device(x.device):
        res_adaln[(n * l,)](x, delta, gate, scale, shift, xo, yo, l, d,
                            gate.stride(0), scale.stride(0), shift.stride(0),
                            eps, BLOCK_D=block, num_warps=warps)
    res_launches += 1
    return xo, yo


class _AdaLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, eps):
        ctx.save_for_backward(x, scale, shift)
        ctx.eps = eps
        return _launch_adaln(x, scale, shift, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = adaln_modulate_plain(*inputs, ctx.eps)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


class _ResidualAdaLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, gate, scale, shift, eps):
        ctx.save_for_backward(x, delta, gate, scale, shift)
        ctx.eps = eps
        return _launch_res_adaln(x, delta, gate, scale, shift, eps)

    @staticmethod
    def backward(ctx, g_x, g_y):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = residual_adaln_modulate_plain(*inputs, ctx.eps)
            grads = torch.autograd.grad(outs, inputs, (g_x, g_y))
        return (*grads, None)


def _on_device(x) -> bool:
    """False for a CPU tensor (plain version); True for CUDA; else raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"fused_adaln runs on CPU or CUDA, not {x.device}")
    return True


def adaln_modulate(x, scale, shift, eps: float = 1e-6):
    """``ln(x) * (1 + scale) + shift``; Triton kernel on CUDA tensors."""
    if not _on_device(x):
        return adaln_modulate_plain(x, scale, shift, eps)
    _check_rows(x, scale, shift)
    return _AdaLN.apply(x, scale, shift, eps)


def residual_adaln_modulate(x, delta, gate, scale, shift, eps: float = 1e-6):
    """``x' = x + gate*delta``; returns ``(x', ln(x')*(1+scale)+shift)``."""
    if not _on_device(x):
        return residual_adaln_modulate_plain(x, delta, gate, scale, shift, eps)
    _check_rows(x, delta, gate, scale, shift)
    return _ResidualAdaLN.apply(x, delta, gate, scale, shift, eps)
