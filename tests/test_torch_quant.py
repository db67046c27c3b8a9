"""int8 W8A8 serving of the port (``opendwm_tpu_torch/ops/quant.py``,
``QLinear``/``QConv2d``, the int8 DiT, UNet and VAE, the quantizer and its
CLI) against the JAX package's (``opendwm_tpu/ops/quant.py``,
``QDense``/``QConv``, ``quantize_param_tree``), on the CPU.

- The integer parts equal JAX's bit for bit: int8 weights and their fp32
  scales, per-token and per-tensor activations, the int8 products of
  ``int8_matmul``/``int8_conv`` (so their outputs too, in fp32 and bf16),
  and the port's quantizer against ``quantize_param_tree`` followed by the
  weight bridge (``convert.py``).
- Tiny int8 models (a DiT with dual attention and both branch kinds, a
  UNet, an SD3.5-style VAE decode) on the same int8 weights: within 1e-3
  of JAX in relative norm ``||port - jax|| / ||jax||`` in fp32.
- The port's int8 models against its float ones on the same weights: the
  JAX package's cosine bars (``tests/test_quant.py``: 0.995 DiT, 0.99 UNet
  and VAE).

The JAX side is built from ``jax.eval_shape`` and numpy draws (no flax
init is compiled). The card's product (``torch._int_mm``) is held to the
CPU's in ``tests/test_torch_quant_cuda.py``.
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from opendwm_tpu.models import layers as jax_layers
from opendwm_tpu.models.autoencoders import AutoencoderKL as JaxVAE
from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu.models.unet import UNetCrossviewTemporal as JaxUNet
from opendwm_tpu.ops import quant as jax_quant
from opendwm_tpu_torch import checkpoint, quantize
from opendwm_tpu_torch.convert import (
    dit_state_dict_from_flax,
    to_torch,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from opendwm_tpu_torch.models.autoencoders import AutoencoderKL
from opendwm_tpu_torch.models.layers import QConv2d, QLinear
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.models.unet import UNetCrossviewTemporal
from opendwm_tpu_torch.ops import quant
from opendwm_tpu_torch.perf import exp_int8_fidelity as exp

from torch_port_helpers import random_flax_params

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-3

# A tiny DiT: 3 joint blocks (the first with dual attention, the last
# context_pre_only), a rowwise cross-view branch at block 1 and a pointwise
# temporal branch at block 2.
TINY_DIT = dict(
    patch_size=2, num_layers=3, attention_head_dim=8, num_attention_heads=4,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=32, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, qk_norm="rms_norm",
    dual_attention_layers=(0,), enable_crossview=True,
    crossview_attention_type="rowwise", crossview_block_layers=(1,),
    enable_temporal=True, temporal_attention_type="pointwise",
    temporal_block_layers=(2,), qk_norm_on_additional_modules="rms_norm",
    perspective_modeling_type="implicit",
    projection_class_embeddings_input_dim=3 * 256,
)
TINY_UNET = dict(  # tests/test_torch_unet.py widths
    in_channels=4, out_channels=4, block_out_channels=(8, 16, 16),
    layers_per_block=1, transformer_layers_per_block=1,
    num_attention_heads=(2, 2, 2), cross_attention_dim=12,
    addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
    merge_factor=2.0,
)
# SD3.5-style: 16 latent channels, no quant convs, conv_out N = 3.
TINY_VAE = dict(block_out_channels=(32, 64), latent_channels=16,
                use_quant_conv=False, scaling_factor=1.5305,
                shift_factor=0.0609)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bits(t) -> np.ndarray:
    """An fp32 or int8 tensor/array as its integer bits."""
    a = np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _zero_qkv_bias(tree):
    """The flax UNet tree with its q/k/v biases zeroed (the reference UNet
    has none; ``unet_state_dict_from_flax`` drops them)."""
    out = {}
    for name, node in tree.items():
        if not isinstance(node, dict):
            out[name] = node
        elif name in ("to_q", "to_k", "to_v"):
            out[name] = dict(node, bias=np.zeros_like(node["bias"]))
        else:
            out[name] = _zero_qkv_bias(node)
    return out


def _jax_pair(make, seed: int, *args, zero_qkv=False, **kwargs):
    """(float params, int8 params) of a flax model: the float tree drawn
    with numpy, the int8 tree by ``quantize_param_tree``."""
    fmodel, qmodel = make(None), make("int8")
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
    fparams = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           random_flax_params(shapes, seed))
    if zero_qkv:
        fparams = _zero_qkv_bias(fparams)
    qshapes = jax.eval_shape(qmodel.init, jax.random.PRNGKey(0), *args,
                             **kwargs)
    qparams = jax.tree.map(np.asarray,
                           jax_quant.quantize_param_tree(fparams, qshapes))
    return fmodel, qmodel, fparams, qparams


def _assert_same_bits(port_sd: dict, bridged: dict):
    assert port_sd.keys() == bridged.keys(), \
        sorted(set(port_sd) ^ set(bridged))[:10]
    for k in port_sd:
        p, b = port_sd[k], np.asarray(bridged[k])
        assert p.dtype == torch.from_numpy(b).dtype, k
        np.testing.assert_array_equal(_bits(p.contiguous()), _bits(b),
                                      err_msg=k)


# -- the scheme, bit for bit ---------------------------------------------------

def _weights_with_edges(rng, k: int, n: int) -> np.ndarray:
    """(K, N) weights whose column 0 is all zero (the 1e-8 floor) and whose
    column 1 has amax 127 (scale 1.0 exactly) and .5 ties."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = rng.integers(-120, 120, k) + 0.5
    w[0, 1] = 127.0
    return w


@pytest.mark.parametrize("kind", ["dense", "conv", "dense_bf16"])
def test_quantize_weight_matches_jax_bit_for_bit(kind):
    rng = np.random.default_rng(0)
    w = _weights_with_edges(rng, 3 * 3 * 5, 7)
    if kind == "conv":
        w = w.reshape(3, 3, 5, 7)
        port_w = torch.from_numpy(w.transpose(3, 0, 1, 2).copy())
        to_port = (3, 0, 1, 2)
    else:
        port_w = torch.from_numpy(w.T.copy())
        to_port = (1, 0)
    jw = jnp.asarray(w)
    if kind == "dense_bf16":
        jw, port_w = jw.astype(jnp.bfloat16), port_w.to(torch.bfloat16)
    wq, ws = jax_quant.quantize_weight(jw)
    pq, ps = quant.quantize_weight(port_w)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(),
                                  np.asarray(wq).transpose(to_port))
    np.testing.assert_array_equal(_bits(ps), _bits(ws))
    assert ps[0].item() == np.float32(1e-8) / np.float32(127)
    assert ps[1].item() == 1.0 and pq[1].flatten()[0].item() == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    x[0, 0] = 0.0  # a zero token
    x[1, 2] = rng.integers(-100, 100, 40) + 0.5  # ties at scale 1
    x[1, 2, 3] = 127.0
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    xq, xs = jax_quant.quantize_activation(jx)
    pq, ps = quant.quantize_activation(px)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(_bits(ps), _bits(xs))
    # the conv activations: one scale for the whole tensor
    tq, ts = quant.quantize_tensor(px)
    s = np.float32(np.abs(np.asarray(jx, np.float32)).max()) / np.float32(127)
    assert ts.ndim == 0 and ts.item() == s
    np.testing.assert_array_equal(tq.numpy(), np.clip(np.round(
        np.asarray(jx, np.float32) / s), -127, 127).astype(np.int8))


@pytest.mark.parametrize("m,k,n", [(5, 36, 3), (40, 64, 24), (16, 20, 4)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(m, k, n, out_dtype):
    rng = np.random.default_rng(m + k + n)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    wq, ws = jax_quant.quantize_weight(jnp.asarray(w))
    ref = jax_quant.int8_matmul(jnp.asarray(x), wq, ws,
                                getattr(jnp, out_dtype))
    out = quant.int8_matmul(torch.from_numpy(x),
                            torch.from_numpy(np.asarray(wq).T.copy()),
                            torch.from_numpy(np.array(ws)),
                            getattr(torch, out_dtype))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("kernel,stride,padding", [
    (1, 1, "SAME"), (3, 1, 1), (3, 1, "SAME"), (3, 2, "SAME"),
    (3, 2, "VALID"), (3, 2, 0), (3, 2, ((0, 1), (1, 0))),
])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_conv_matches_jax(kernel, stride, padding, out_dtype):
    """Cin 4 x 3 x 3 is K = 36 and Cout 3 is N = 3: neither a multiple
    of 8; the card pads both."""
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    w = (rng.standard_normal((kernel, kernel, 4, 3)) * 0.2).astype(np.float32)
    wq, ws = jax_quant.quantize_weight(jnp.asarray(w))
    jpad = ((padding, padding),) * 2 if isinstance(padding, int) else padding
    ref = jax_quant.int8_conv(jnp.asarray(x), wq, ws, (stride, stride),
                              jpad, getattr(jnp, out_dtype))
    out = quant.int8_conv(torch.from_numpy(x),
                          torch.from_numpy(np.asarray(wq)
                                           .transpose(3, 0, 1, 2).copy()),
                          torch.from_numpy(np.array(ws)), (stride, stride),
                          padding, getattr(torch, out_dtype))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_conv_scale_is_set_by_the_whole_batch():
    """One image 50x larger sets the per-tensor scale of the whole batch:
    the other image's result moves against its conv alone, as in JAX (so
    CFG batching and decode chunking change int8 results)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    x[1] *= 50.0
    w = (rng.standard_normal((3, 3, 4, 8)) * 0.2).astype(np.float32)
    wq, ws = jax_quant.quantize_weight(jnp.asarray(w))
    pw = torch.from_numpy(np.asarray(wq).transpose(3, 0, 1, 2).copy())
    pws = torch.from_numpy(np.array(ws))
    both = quant.int8_conv(torch.from_numpy(x), pw, pws, (1, 1), "SAME",
                           torch.float32)
    alone = quant.int8_conv(torch.from_numpy(x[:1]), pw, pws, (1, 1),
                            "SAME", torch.float32)
    ref = jax_quant.int8_conv(jnp.asarray(x), wq, ws, (1, 1), "SAME",
                              jnp.float32)
    np.testing.assert_array_equal(both.numpy(), np.asarray(ref))
    assert _rel(both[:1], alone) > 0.05


def test_qlinear_quantizes_its_input_in_the_dtype_it_arrives_in():
    """``QDense`` does not cast x to its compute dtype before quantizing:
    an fp32 input to a bf16 layer is quantized in fp32. The port's QLinear
    gives JAX's bits for the fp32 and the bf16 input, and the two differ."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 24)).astype(np.float32)
    jmod = jax_layers.QDense(16, dtype=jnp.bfloat16)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, params)
    params["params"]["bias"] = rng.standard_normal(16).astype(np.float32)
    layer = QLinear(24, 16)
    p = params["params"]
    layer.load_state_dict({
        "weight_q": torch.from_numpy(p["kernel_q"].T.copy()),
        "weight_scale": torch.from_numpy(p["kernel_scale"]),
        "bias": torch.from_numpy(p["bias"])})
    layer.compute_dtype = torch.bfloat16
    outs = {}
    for name, jx, px in (
            ("fp32", jnp.asarray(x), torch.from_numpy(x)),
            ("bf16", jnp.asarray(x).astype(jnp.bfloat16),
             torch.from_numpy(x).to(torch.bfloat16))):
        ref = np.asarray(jmod.apply(params, jx), np.float32)
        with torch.no_grad():
            outs[name] = layer(px).float().numpy()
        np.testing.assert_array_equal(outs[name], ref)
    assert not np.array_equal(outs["fp32"], outs["bf16"])


def test_weight_scale_stays_fp32_through_dtype_casts():
    """``.to(bfloat16)``, ``.half()`` and ``to_empty`` move the int8 state
    but keep ``weight_scale`` fp32 (and its bits), as flax keeps
    ``kernel_scale``; the model constructors cast with ``.to(dtype)``."""
    layer = QLinear(8, 4)
    layer.weight_scale.copy_(torch.tensor([1.1, 2.2, 3.3, 4.4]) / 127)
    scale = layer.weight_scale.clone()
    layer.to(torch.bfloat16)
    assert layer.weight_scale.dtype == torch.float32
    assert layer.weight_q.dtype == torch.int8
    assert layer.bias.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(layer.weight_scale), _bits(scale))
    conv = QConv2d(3, 4, 3, padding=1).half()
    assert conv.weight_scale.dtype == torch.float32
    with torch.device("meta"):
        dit = DiTCrossviewTemporal(**TINY_DIT, quantization="int8",
                                   dtype=torch.bfloat16)
    dit.to_empty(device="cpu")
    scales = [m.weight_scale.dtype for m in dit.modules()
              if isinstance(m, QLinear)]
    assert scales and set(scales) == {torch.float32}
    vae = AutoencoderKL(**TINY_VAE, dtype=torch.bfloat16,
                        quantization="int8")
    assert {b.dtype for n, b in vae.named_buffers()
            if n.endswith("weight_scale")} == {torch.float32}
    assert vae.dtype == torch.bfloat16


def test_unknown_quantization_raises():
    for build in (lambda q: DiTCrossviewTemporal(**TINY_DIT, quantization=q),
                  lambda q: UNetCrossviewTemporal(**TINY_UNET,
                                                  quantization=q),
                  lambda q: AutoencoderKL(**TINY_VAE, quantization=q)):
        with pytest.raises(ValueError, match="int4"):
            build("int4")


# -- tiny models against JAX -------------------------------------------------

def _dit_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    b, t, v, h, w = 1, 2, 2, 8, 12
    inputs = {
        "sample": rng.standard_normal((b, t, v, h, w, 16)),
        "timestep": rng.uniform(0, 1000, (b, t, v)),
        "encoder_hidden_states": rng.standard_normal((b, t, v, 10, 24)),
        "pooled_projections": rng.standard_normal((b, t, v, 16)),
        "added_time_ids": rng.standard_normal((b, t, v, 3)),
    }
    return {k: v.astype(np.float32) for k, v in inputs.items()}


def _unet_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    inputs = dict(
        sample=rng.standard_normal((1, 2, 2, 16, 16, 4)),
        timestep=rng.uniform(0, 1000, (1, 2, 2)),
        encoder_hidden_states=rng.standard_normal((1, 2, 2, 5, 12)),
        added_time_ids=rng.standard_normal((1, 2, 2, 3)),
    )
    return {k: v.astype(np.float32) for k, v in inputs.items()}


def _jnp(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax_quantized_inputs(fn, *args):
    """``jax.jit(fn)(*args)`` (``fn``: an apply of a flax model), and the
    input of every ``QDense``/``QConv`` call in it, in call order."""
    def captured(*a):
        seen = []

        def interceptor(next_fun, args, kwargs, context):
            if context.method_name == "__call__" and isinstance(
                    context.module, (jax_layers.QDense, jax_layers.QConv)):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(interceptor):
            return fn(*a), seen

    out, seen = jax.jit(captured)(*args)
    return np.asarray(out), [np.asarray(x) for x in seen]


@contextlib.contextmanager
def _forced(model, inputs: list, stats: dict):
    """Every ``QLinear``/``QConv2d`` call under ``model`` takes the next of
    JAX's ``inputs`` in place of its own, so both packages quantize the
    same values. ``stats``: ``flips``, the int8 activations that the
    port's own input would have rounded otherwise, of ``elements``;
    ``max_step``, the largest such difference in int8 steps;
    ``input_rel``, the largest relative-norm distance of the port's own
    input to a layer from JAX's."""
    queue = iter(inputs)
    stats.update(flips=0, elements=0, calls=0, max_step=0, input_rel=0.0)

    def pre(module, args):
        own = args[0]
        theirs = torch.from_numpy(next(queue))
        quantize = quant.quantize_activation
        if isinstance(module, QConv2d):  # NCHW view of NHWC, as the port
            theirs, quantize = theirs.movedim(-1, 1), quant.quantize_tensor
        assert theirs.shape == own.shape, (theirs.shape, own.shape)
        step = (quantize(own)[0].to(torch.int16) -
                quantize(theirs)[0].to(torch.int16)).abs()
        stats["flips"] += int((step != 0).sum())
        stats["elements"] += step.numel()
        stats["max_step"] = max(stats["max_step"], int(step.max()))
        stats["input_rel"] = max(stats["input_rel"], _rel(own, theirs))
        stats["calls"] += 1
        return (theirs,)

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, (QLinear, QConv2d))]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
    assert stats["calls"] == len(inputs)


@pytest.fixture(scope="module")
def dit():
    inputs = _dit_inputs(0)
    jf, jq, fparams, qparams = _jax_pair(
        lambda q: JaxDiT(**TINY_DIT, quantization=q), 2, **_jnp(inputs))
    port = DiTCrossviewTemporal(**TINY_DIT).eval()
    port.load_state_dict(to_torch(dit_state_dict_from_flax(fparams, 3)))
    qport = DiTCrossviewTemporal(**TINY_DIT, quantization="int8").eval()
    qport.load_state_dict(to_torch(dit_state_dict_from_flax(qparams, 3)))
    ref, seen = _jax_quantized_inputs(lambda p, kw: jq.apply(p, **kw),
                                      qparams, _jnp(inputs))
    return dict(inputs=inputs, port=port, qport=qport, qparams=qparams,
                ref=ref, seen=seen, run=lambda m: m(**_torch(inputs)))


@pytest.fixture(scope="module")
def unet():
    inputs = _unet_inputs(0)
    jf, jq, fparams, qparams = _jax_pair(
        lambda q: JaxUNet(**TINY_UNET, quantization=q), 1, zero_qkv=True,
        **_jnp(inputs))
    port = UNetCrossviewTemporal(**TINY_UNET).eval()
    port.load_state_dict(to_torch(unet_state_dict_from_flax(fparams)))
    qport = UNetCrossviewTemporal(**TINY_UNET, quantization="int8").eval()
    qport.load_state_dict(to_torch(unet_state_dict_from_flax(qparams)))
    ref, seen = _jax_quantized_inputs(lambda p, kw: jq.apply(p, **kw),
                                      qparams, _jnp(inputs))
    return dict(inputs=inputs, port=port, qport=qport, qparams=qparams,
                ref=ref, seen=seen, run=lambda m: m(**_torch(inputs)))


@pytest.fixture(scope="module")
def vae():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 3, 6, 8, 16)).astype(np.float32)
    jf, jq, fparams, qparams = _jax_pair(
        lambda q: JaxVAE(**TINY_VAE, quantization=q), 3,
        jnp.zeros((1, 12, 16, 3)))
    port = AutoencoderKL(**TINY_VAE).eval()
    port.load_state_dict(to_torch(vae_state_dict_from_flax(fparams)))
    qport = AutoencoderKL(**TINY_VAE, quantization="int8").eval()
    qport.load_state_dict(to_torch(vae_state_dict_from_flax(qparams)))
    ref, seen = _jax_quantized_inputs(jq.decode_from_scaled, qparams,
                                      jnp.asarray(z))
    # the same latents decoded 4 images at a time (per-tensor scales)
    flat = z.reshape(-1, 6, 8, 16)
    chunks = [_jax_quantized_inputs(jq.decode_from_scaled, qparams,
                                    jnp.asarray(flat[i:i + 4]))
              for i in range(0, 6, 4)]
    return dict(z=z, port=port, qport=qport, qparams=qparams, ref=ref,
                seen=seen, ref_chunked=np.concatenate([c[0] for c in chunks])
                .reshape(ref.shape),
                seen_chunked=[x for c in chunks for x in c[1]],
                run=lambda m: m.decode_from_scaled(torch.from_numpy(z)))


@pytest.mark.parametrize("family", ["dit", "unet", "vae"])
def test_tiny_int8_model_matches_jax(family, dit, unet, vae,
                                     record_property):
    """The port's int8 model on JAX's int8 weights (``convert.py``), each
    quantized layer given the input that JAX's gave its twin, within 1e-3
    of JAX in relative norm. The port's own input to each quantized layer
    (its norms, attention, GEGLU and layout code, run on the forced
    outputs before it) is held too: within 1e-3 of JAX's, and rounding at
    most one int8 step away from it in at most 1e-3 of the activations."""
    case = {"dit": dit, "unet": unet, "vae": vae}[family]
    stats: dict = {}
    with torch.no_grad(), _forced(case["qport"], case["seen"], stats):
        out = case["run"](case["qport"])
    _check_own_inputs(stats, record_property)
    assert out.shape == case["ref"].shape
    assert _rel(out, case["ref"]) <= REL_TOL


def _check_own_inputs(stats: dict, record_property) -> None:
    record_property("rounding_flips", f"{stats['flips']} of "
                    f"{stats['elements']} in {stats['calls']} layer calls")
    record_property("own_input_rel_max", stats["input_rel"])
    assert stats["input_rel"] <= REL_TOL
    assert stats["max_step"] <= 1
    assert stats["flips"] <= REL_TOL * stats["elements"]


@contextlib.contextmanager
def _nudged(model):
    """The first ``QLinear``/``QConv2d`` call under ``model`` with one
    activation moved by one int8 step: the element of median magnitude,
    plus its scale, so that it rounds one step up."""
    def pre(module, args):
        for h in hooks:
            h.remove()
        x = args[0].clone(memory_format=torch.contiguous_format)
        quantize = quant.quantize_tensor if isinstance(module, QConv2d) \
            else quant.quantize_activation
        q, scale = quantize(x)
        i = int(x.abs().flatten().argsort()[x.numel() // 2])
        x.view(-1)[i] += scale.expand_as(x).reshape(-1)[i]
        assert int((quantize(x)[0] != q).sum()) == 1
        return (x,)

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, (QLinear, QConv2d))]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@pytest.mark.parametrize("family", ["dit", "unet", "vae"])
def test_one_rounding_flip_cascades(family, dit, unet, vae, record_property):
    """Why the parity above gives each quantized layer JAX's input: one
    int8 activation moved by one step in the first quantized layer moves
    the output by more than 1e-3 (each flip moves the next layer's inputs
    enough to flip more), so the fp32 differences of ~1e-7 between the
    packages, which flip a few roundings, can take the port left to its
    own inputs past 1e-3 from JAX. That gap stays within the scheme's own
    distance from the float model (a port fault would not)."""
    case = {"dit": dit, "unet": unet, "vae": vae}[family]
    with torch.no_grad():
        base = case["run"](case["qport"])
        with _nudged(case["qport"]):
            moved = case["run"](case["qport"])
        noise = _rel(base, case["run"](case["port"]))
    gap = _rel(base, case["ref"])
    record_property("one_flip_moves", _rel(moved, base))
    record_property("unforced_gap_to_jax", gap)
    assert _rel(moved, base) > REL_TOL
    assert gap < noise


def test_tiny_int8_vae_decode_chunking_matches_jax(vae, record_property):
    """Decoded 4 images at a time, each chunk's per-tensor scales follow
    JAX's chunks (forced and held as above), and the result differs from
    the whole decode's: the conv scales are per tensor."""
    stats: dict = {}
    with torch.no_grad():
        with _forced(vae["qport"], vae["seen_chunked"], stats):
            chunked = vae["qport"].decode_from_scaled(
                torch.from_numpy(vae["z"]), chunk_size=4)
    _check_own_inputs(stats, record_property)
    assert _rel(chunked, vae["ref_chunked"]) <= REL_TOL
    assert _rel(vae["ref_chunked"], vae["ref"]) > 10 * REL_TOL


@pytest.mark.parametrize("family", ["dit", "unet", "vae"])
def test_port_quantizer_equals_quantize_param_tree(family, dit, unet, vae):
    """The port's quantizer on the port's float weights gives the int8
    state dict that ``quantize_param_tree`` + the weight bridge give, bit
    for bit."""
    case = {"dit": dit, "unet": unet, "vae": vae}[family]
    bridge = {"dit": lambda p: dit_state_dict_from_flax(p, 3),
              "unet": unet_state_dict_from_flax,
              "vae": vae_state_dict_from_flax}[family]
    ours = quant.quantize_state_dict(case["port"].state_dict(),
                                     case["qport"])
    _assert_same_bits(ours, bridge(case["qparams"]))


def _quantized_twin(model, build):
    qmodel = build("int8").eval()
    qmodel.load_state_dict(quant.quantize_state_dict(model.state_dict(),
                                                     qmodel))
    return qmodel


@pytest.mark.parametrize("family", ["dit", "unet", "vae"])
def test_int8_tracks_the_float_port(family, dit):
    """The port's int8 model against its float model on the same weights
    (torch's default init, seed 0; the DiT's from the fixture), at the
    JAX package's bars on its own test configurations and inputs
    (``tests/test_quant.py``)."""
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    if family == "dit":
        f, q = dit["port"], dit["qport"]
        run = dit["run"]
        bar = exp.DIT_COSINE
    elif family == "unet":
        cfg = dict(in_channels=8, out_channels=4, block_out_channels=(32, 64),
                   layers_per_block=1, num_attention_heads=(2, 4),
                   addition_time_embed_dim=8,
                   projection_class_embeddings_input_dim=24)
        build = lambda q: UNetCrossviewTemporal(  # noqa: E731
            **cfg, quantization=q)
        f = build(None).eval()
        q = _quantized_twin(f, build)
        kw = dict(sample=torch.randn(1, 2, 2, 8, 8, 8, generator=g) * 0.5,
                  timestep=torch.full((1, 2, 2), 500.0),
                  encoder_hidden_states=torch.randn(1, 2, 2, 3, 1024,
                                                    generator=g),
                  added_time_ids=torch.zeros(1, 2, 2, 3))
        run = lambda m: m(**kw)  # noqa: E731
        bar = exp.UNET_COSINE
    else:
        build = lambda q: AutoencoderKL(  # noqa: E731
            block_out_channels=(32, 64), latent_channels=4, quantization=q)
        f = build(None).eval()
        q = _quantized_twin(f, build)
        x = torch.randn(1, 16, 16, 3, generator=g) * 0.5
        run = lambda m: m.decode(m.encode(x)[0])  # noqa: E731
        bar = exp.VAE_COSINE
    with torch.no_grad():
        out_f, out_q = run(f), run(q)
    assert torch.isfinite(out_q).all()
    assert exp.cosine(out_f, out_q) >= bar


@pytest.mark.parametrize("family", ["dit", "unet", "vae"])
def test_census_counts_one_integer_product_per_layer_call(family, dit, unet,
                                                          vae):
    """``Int8Census`` sees one integer product and no float GEMM in every
    quantized layer call, as many calls as the architecture implies
    (``*_int8_calls``, read from the config), and flags a float GEMM."""
    case = {"dit": dit, "unet": unet, "vae": vae}[family]
    if family == "vae":
        want = exp.vae_decoder_int8_calls(TINY_VAE["block_out_channels"])
        run = lambda: case["qport"].decode(  # noqa: E731
            torch.from_numpy(vae["z"][0, :1]))
    else:
        cfg = TINY_DIT if family == "dit" else TINY_UNET
        want = (exp.dit_int8_calls(cfg) if family == "dit"
                else exp.unet_int8_calls(cfg))
        run = lambda: case["qport"](**_torch(case["inputs"]))  # noqa: E731
    modules = sum(isinstance(m, (QLinear, QConv2d))
                  for m in case["qport"].modules())
    if family != "vae":
        assert want == modules
    census = exp.Int8Census(case["qport"])
    with torch.no_grad(), census:
        run()
    summary = census.check(want, family)
    assert summary["integer_products"] == want
    # a float GEMM inside a quantized layer fails the census
    ran = case["qport"].decoder if family == "vae" else case["qport"]
    layer = next(m for m in ran.modules() if isinstance(m, QLinear))
    orig = layer.forward
    layer.forward = lambda x: orig(x) + 0 * (x.float() @ torch.zeros(
        x.shape[-1], layer.out_features)).to(orig(x).dtype)
    try:
        census = exp.Int8Census(case["qport"])
        with torch.no_grad(), census:
            run()
        with pytest.raises(AssertionError, match="not"):
            census.check(want, family)
    finally:
        del layer.forward


def test_architecture_counts_at_full_width():
    """The counts the card's census gates on: the CTSD-3.5 DiT (24 joint
    blocks, 13 dual, 6 + 12 branch blocks), the CTSD-2.1 UNet, the SD3.5
    VAE decoder, each against the modules of the model built on the meta
    device (every module runs once a forward)."""
    for path, want in (
            ("configs/ctsd/multi_datasets/ctsd_35_tirda_nwao.json", 481),
            ("configs/ctsd/multi_datasets/ctsd_21_tirda_nwao.json", None)):
        cfg = json.loads((REPO / path).read_text())["pipeline"]["model"]
        cls = UNetCrossviewTemporal if "unet" in cfg["_class_name"] \
            else DiTCrossviewTemporal
        count = exp.dit_int8_calls if cls is DiTCrossviewTemporal \
            else exp.unet_int8_calls
        kw = {k: v for k, v in cfg.items()
              if k not in ("_class_name", "dtype")}
        with torch.device("meta"):
            model = cls(**kw, quantization="int8")
        modules = sum(isinstance(m, (QLinear, QConv2d))
                      for m in model.modules())
        assert count(cfg) == modules
        if want is not None:
            assert modules == want
    with torch.device("meta"):
        vae_model = AutoencoderKL(latent_channels=16, use_quant_conv=False,
                                  quantization="int8")
    decoder = sum(isinstance(m, (QLinear, QConv2d))
                  for m in vae_model.decoder.modules())
    assert exp.vae_decoder_int8_calls() == decoder


# -- the quantizer CLI, the fidelity experiment, imports ----------------------

def test_quantize_cli_on_a_tiny_config(tmp_path, dit):
    cfg = {"model": {
        "_class_name":
            "dwm.models.crossview_temporal_dit"
            ".DiTCrossviewTemporalConditionModel",
        **{k: (list(v) if isinstance(v, tuple) else v)
           for k, v in TINY_DIT.items()}}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    checkpoint.save_model_only(tmp_path / "float.pt", dit["port"])
    quantize.main(["--config", str(tmp_path / "cfg.json"), "--model-key",
                   "model", "--input", str(tmp_path / "float.pt"),
                   "--output", str(tmp_path / "int8.pt"), "--device", "cpu"])
    qstate = checkpoint.load_model_only(tmp_path / "int8.pt")
    _assert_same_bits(qstate, dit_state_dict_from_flax(dit["qparams"], 3))
    model = DiTCrossviewTemporal(**TINY_DIT, quantization="int8").eval()
    checkpoint.load_model_only(tmp_path / "int8.pt", model)
    with torch.no_grad():
        out = model(**_torch(dit["inputs"]))
    assert _rel(out, dit["ref"]) <= REL_TOL
    with pytest.raises(KeyError, match="float model"):
        quantize.quantize_checkpoint(cfg["model"], qstate)


def test_quantize_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without ``--device`` the CLI quantizes on the card, and raises where
    torch sees none, as the port's other entry points do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize.main(["--config", str(tmp_path / "cfg.json"),
                       "--input", str(tmp_path / "float.pt"),
                       "--output", str(tmp_path / "int8.pt")])


def test_fidelity_experiment_runs_at_a_tiny_size():
    """``exp_int8_fidelity.run`` on the CPU: a tiny flow-match pipeline
    and its int8 twin built by ``build_pair``, one CFG forward and a
    2-window rollout of each."""
    cfg = json.loads((REPO / "configs/ctsd/ctsd_35_6views_video_synthetic"
                      ".json").read_text())["pipeline"]
    cfg["model"] = {"_class_name": cfg["model"]["_class_name"],
                    **{k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in TINY_DIT.items()},
                    "joint_attention_dim": 24, "pooled_projection_dim": 16,
                    "perspective_modeling_type": ""}
    cfg["inference_config"]["inference_steps"] = 2
    gen = torch.Generator().manual_seed(0)

    def init_(model, g):
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0.0, p[0].numel() ** -0.5 if p.ndim > 1 else 0.05,
                          generator=g)

    pipe, qpipe = exp.build_pair(cfg, torch.device("cpu"), init_, gen)
    t, v, h, w = 3, 2, 8, 8
    batch = {
        "encoder_hidden_states": torch.randn(1, 3, v, 6, 24, generator=gen),
        "pooled_projections": torch.randn(1, 3, v, 16, generator=gen),
        "camera_intrinsics": torch.eye(3).expand(1, 3, v, 3, 3),
        "camera_transforms": torch.eye(4).expand(1, 3, v, 4, 4),
        "image_size": torch.tensor([64.0, 64.0]).expand(1, 3, v, 2),
        "fps": torch.full((1,), 10.0),
    }
    from opendwm_tpu_torch.pipelines.ctsd import get_conditions

    kwargs = dict(sample=torch.randn(2, t - 1, v, h, w, 16, generator=gen),
                  timestep=torch.full((2, t - 1, v), 500.0),
                  **get_conditions(
                      {k: a[:, :t - 1] if a.ndim > 1 else a
                       for k, a in batch.items()},
                      pipe.common_config, do_classifier_free_guidance=True))
    order: list = []
    report, lat = exp.run(pipe, qpipe, kwargs, batch, (1, t - 1, v, h, w, 16),
                          total_frames=t, before=order.append)
    assert order == ["bf16", "int8"] and set(report["rollout_s"]) == {
        "bf16", "int8"}
    assert lat.shape == (1, t, v, h, w, 16) and torch.isfinite(lat).all()
    assert report["forward"]["cosine"] >= exp.DIT_COSINE
    assert report["rollout"]["cosine"] > 0.9
    assert set(report["forward"]) >= {"max_rel_err", "max_rel_err_where_big"}


def test_forward_fidelity_is_the_jax_scripts_report():
    """``forward_fidelity`` computes ``perf/exp_int8_fidelity.py``'s
    numbers: the relative error over max(|ref|, 1e-3), its maximum where
    |ref| > 0.1 std(ref) (population std)."""
    ref = torch.tensor([0.0005, 1.0, -2.0, 0.05, 3.0])
    out = torch.tensor([0.0015, 1.1, -2.0, 0.06, 2.7])
    r = exp.forward_fidelity(ref, out)
    rel = np.abs(out.numpy() - ref.numpy()) / np.maximum(np.abs(ref.numpy()),
                                                          1e-3)
    big = np.abs(ref.numpy()) > 0.1 * ref.numpy().std()
    assert r["max_rel_err"] == pytest.approx(rel.max())
    assert r["max_rel_err_where_big"] == pytest.approx(rel[big].max())
    assert r["max_rel_err_at"]["float_value"] == pytest.approx(0.0005)


def test_int8_modules_import_no_jax():
    code = ("import sys\n"
            "from opendwm_tpu_torch import quantize\n"
            "from opendwm_tpu_torch.ops import quant\n"
            "from opendwm_tpu_torch.perf import exp_int8_fidelity\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'opendwm_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
