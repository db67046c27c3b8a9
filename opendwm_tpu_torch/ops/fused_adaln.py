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

The Hopper kernels are CUDA C++ in ``csrc/adaln.cu`` (design and what
bounds them are noted there), built with nvcc at first use and called
through ctypes: at a width of ``RING_WIDTHS`` (d 1024, the LiDAR DiT's;
d 1536, the other DiTs') rows reach shared memory by 1-D bulk copies into
a ring and one warp takes a row in registers; at any other width or
alignment one warp streams its row (``instance`` picks). No matrix product
is involved, so each is bound by device-memory bytes: one read of x (and
delta) and one write of each output. x' is rounded once from the fp32
``x + gate * delta`` without FMA contraction, so it equals the plain
version's bit for bit. The wrappers take the plain
versions only for CPU tensors; for a CUDA tensor they launch the kernel or
raise. A call that needs a gradient goes through an autograd Function whose
backward is autograd of the plain version, as in the JAX package.

Where the residual form rounds: the kernel normalises the fp32 sum
``x + gate * delta`` (as ``_res_kernel`` does), not the sum rounded to
``x.dtype`` (as ``_res_reference`` does); the plain version follows the
kernel. In fp32 the two agree.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import torch

from opendwm_tpu_torch.ops import _build

# Kernel launches of K3 (adaln_modulate) and K4 (residual_adaln_modulate):
# in total, those that ran the ring (the bulk-copy kernel at a width of
# RING_WIDTHS), and by (n, L, d).
launches = 0
res_launches = 0
fixed_launches = 0
res_fixed_launches = 0
launches_by_shape: dict[tuple, int] = {}
res_launches_by_shape: dict[tuple, int] = {}


def reset_launches() -> None:
    global launches, res_launches, fixed_launches, res_fixed_launches
    launches = res_launches = fixed_launches = res_fixed_launches = 0
    launches_by_shape.clear()
    res_launches_by_shape.clear()


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


# -- the CUDA kernels (csrc/adaln.cu, built at first use) --------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _ring_widths() -> tuple[int, ...]:
    """The widths ``csrc/adaln.cu`` compiles its ring for, read from its
    ``RingWidths`` so that this module and the library hold one list:
    every DiT width the configs build at full width (16 x 64 and 24 x 64
    heads)."""
    text = (Path(__file__).resolve().parent.parent / "csrc" /
            "adaln.cu").read_text()
    m = re.search(r"using RingWidths = Widths<([\d, ]+)>;", text)
    if m is None:
        raise RuntimeError("csrc/adaln.cu declares no RingWidths")
    return tuple(int(w) for w in m[1].split(","))


RING_WIDTHS = _ring_widths()


def instance(d: int, dtype, mod_dtype, *addresses: int) -> str:
    """Which kernel of ``csrc/adaln.cu`` a launch runs: ``"fixed"`` (the
    ring, which bulk-copies rows and vectors into shared memory) when d is
    one of ``RING_WIDTHS``, x's type is one the kernels take, the
    modulation vectors share it, and every address (the row pointers of x,
    delta and the outputs, the vectors' pointers and their per-sample
    strides in bytes) is a multiple of 16; else ``"any"`` (runtime
    width)."""
    if d in RING_WIDTHS and dtype in _DTYPES and mod_dtype == dtype and \
            all(a % 16 == 0 for a in addresses):
        return "fixed"
    return "any"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("adaln.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tail = [ctypes.c_float, i32, i32, i32, ptr]  # eps, dtypes, ring, stream
    lib.adaln_forward.argtypes = [ptr] * 4 + [i32] * 3 + [i64] * 2 + tail
    lib.residual_adaln_forward.argtypes = [ptr] * 7 + [i32] * 3 + \
        [i64] * 3 + tail
    lib.adaln_forward.restype = ctypes.c_int
    lib.residual_adaln_forward.restype = ctypes.c_int
    lib.adaln_error_string.argtypes = [ctypes.c_int]
    lib.adaln_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the CUDA kernels now rather than at first launch."""
    _library()


def _check_rows(x, *others) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (n, L, d); got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_adaln takes a float x, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_adaln takes a contiguous x")
    for t in others:
        if t.device != x.device:
            raise ValueError("all fused_adaln inputs must lie on one device")


def _vecs(n: int, d: int, x_dtype, *ts):
    """The modulation vectors as (n, d) views, contiguous along d, of one
    type the kernels read: their own if they share one and x is not fp32,
    else fp32 copies (values the kernels would read as fp32 anyway; an
    fp32 x with fp32 vectors runs the ring)."""
    out = []
    for t in ts:
        if t.ndim != 2 or t.shape != (n, d):
            t = _per_sample(t, n, d)
        if t.stride(-1) != 1:
            raise ValueError("modulation vectors must be contiguous along d")
        out.append(t)
    dtype = out[0].dtype
    if dtype not in _DTYPES or x_dtype == torch.float32 or \
            any(t.dtype != dtype for t in out):
        out = [t.float() for t in out]
    return out


def _addresses(*ts) -> list[int]:
    """Each tensor's address and, for the (n, d) vectors, their per-sample
    stride in bytes: what the ring needs aligned."""
    out = []
    for t in ts:
        out.append(t.data_ptr())
        if t.ndim == 2:
            out.append(t.stride(0) * t.element_size())
    return out


def _raise_on_error(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().adaln_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _launch_adaln(x, scale, shift, eps):
    global launches, fixed_launches
    n, l, d = x.shape
    scale, shift = _vecs(n, d, x.dtype, scale, shift)
    out = torch.empty_like(x)
    ring = instance(d, x.dtype, scale.dtype,
                    *_addresses(x, out, scale, shift)) == "fixed"
    rc = _library().adaln_forward(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n,
        l, d, scale.stride(0), shift.stride(0), eps, _DTYPES[x.dtype],
        _DTYPES[scale.dtype], ring,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(rc, "adaln_modulate")
    launches += 1
    fixed_launches += ring
    launches_by_shape[n, l, d] = launches_by_shape.get((n, l, d), 0) + 1
    return out


def _launch_res_adaln(x, delta, gate, scale, shift, eps):
    global res_launches, res_fixed_launches
    n, l, d = x.shape
    if delta.shape != x.shape or delta.dtype != x.dtype or \
            not delta.is_contiguous():
        raise ValueError("delta must be contiguous, with x's shape and dtype")
    gate, scale, shift = _vecs(n, d, x.dtype, gate, scale, shift)
    xo, yo = torch.empty_like(x), torch.empty_like(x)
    ring = instance(d, x.dtype, gate.dtype, *_addresses(
        x, delta, xo, yo, gate, scale, shift)) == "fixed"
    rc = _library().residual_adaln_forward(
        x.data_ptr(), delta.data_ptr(), gate.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), xo.data_ptr(), yo.data_ptr(), n, l, d,
        gate.stride(0), scale.stride(0), shift.stride(0), eps,
        _DTYPES[x.dtype], _DTYPES[gate.dtype], ring,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error(rc, "residual_adaln_modulate")
    res_launches += 1
    res_fixed_launches += ring
    res_launches_by_shape[n, l, d] = \
        res_launches_by_shape.get((n, l, d), 0) + 1
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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def adaln_modulate(x, scale, shift, eps: float = 1e-6):
    """``ln(x) * (1 + scale) + shift``; the K3 kernel on CUDA tensors."""
    if not _on_device(x):
        return adaln_modulate_plain(x, scale, shift, eps)
    _check_rows(x, scale, shift)
    if _needs_grad(x, scale, shift):
        return _AdaLN.apply(x, scale, shift, eps)
    return _launch_adaln(x, scale, shift, eps)


def residual_adaln_modulate(x, delta, gate, scale, shift, eps: float = 1e-6):
    """``x' = x + gate*delta``; returns ``(x', ln(x')*(1+scale)+shift)``;
    the K4 kernel on CUDA tensors."""
    if not _on_device(x):
        return residual_adaln_modulate_plain(x, delta, gate, scale, shift, eps)
    _check_rows(x, delta, gate, scale, shift)
    if _needs_grad(x, delta, gate, scale, shift):
        return _ResidualAdaLN.apply(x, delta, gate, scale, shift, eps)
    return _launch_res_adaln(x, delta, gate, scale, shift, eps)
