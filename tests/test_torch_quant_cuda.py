"""int8 serving on the card (``opendwm_tpu_torch/ops/quant.py``) against
the CPU's plain int32 product, bit for bit.

``torch._int_mm`` takes more than 16 rows and K and N that are multiples
of 8: the wrapper pads with zero int8, which adds nothing, so every shape
gives the CPU's integers, and the fp32 quantize/dequantize arithmetic
(divisions by tensors, round half to even) gives its bits. Every test
here needs an NVIDIA GPU and skips without one. The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_quant_cuda.py -q
"""

import json

import pytest
import torch

from opendwm_tpu_torch import checkpoint, quantize
from opendwm_tpu_torch.models.layers import QConv2d
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda

# The CLI's tiny DiT (tests/test_torch_quant.py's, with lists for JSON).
TINY_DIT = dict(
    patch_size=2, num_layers=3, attention_head_dim=8, num_attention_heads=4,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=32, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, qk_norm="rms_norm",
    dual_attention_layers=[0], enable_crossview=True,
    crossview_attention_type="rowwise", crossview_block_layers=[1],
    enable_temporal=True, temporal_attention_type="pointwise",
    temporal_block_layers=[2], qk_norm_on_additional_modules="rms_norm",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _int8(shape, g):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", [
    (1, 36, 3), (5, 20, 4), (16, 8, 8), (17, 27, 3), (40, 64, 24),
    (100, 2880, 320), (257, 1536, 1536),
])
def test_int8_mm_pads_to_the_cpu_integers(cuda, m, k, n):
    g = torch.Generator().manual_seed(m * k + n)
    a, w = _int8((m, k), g), _int8((n, k), g)
    quant.reset_launches()
    out = quant.int8_mm(a.to(cuda), w.to(cuda))
    assert quant.launches == 1
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out.cpu(), quant.int8_mm(a, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizers_give_the_cpu_bits(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(37, 3, 3, 5, generator=g).to(dtype)
    w[0] = 0.0
    x = (torch.randn(7, 9, 40, generator=g) * 3).to(dtype)
    x[1, 2] = torch.arange(40) - 19.5  # ties at scale 1 after amax 127
    x[1, 2, 0] = 127.0
    for fn in (quant.quantize_weight, quant.quantize_activation,
               quant.quantize_tensor):
        src = w if fn is quant.quantize_weight else x
        (q_gpu, s_gpu), (q_cpu, s_cpu) = fn(src.to(cuda)), fn(src)
        assert torch.equal(q_gpu.cpu(), q_cpu)
        assert torch.equal(s_gpu.cpu().view(torch.int32),
                           s_cpu.view(torch.int32))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_and_conv_give_the_cpu_bits(cuda, in_dtype, out_dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 36, generator=g).to(in_dtype)
    wq, ws = quant.quantize_weight(torch.randn(3, 36, generator=g))
    out = quant.int8_matmul(x.to(cuda), wq.to(cuda), ws.to(cuda), out_dtype)
    assert torch.equal(out.cpu(), quant.int8_matmul(x, wq, ws, out_dtype))
    img = torch.randn(2, 9, 11, 4, generator=g).to(in_dtype)
    cq, cs = quant.quantize_weight(torch.randn(3, 3, 3, 4, generator=g))
    for stride, padding in (((1, 1), 1), ((2, 2), "SAME"), ((2, 2), 0)):
        out = quant.int8_conv(img.to(cuda), cq.to(cuda), cs.to(cuda),
                              stride, padding, out_dtype)
        ref = quant.int8_conv(img, cq, cs, stride, padding, out_dtype)
        assert torch.equal(out.cpu(), ref)


def test_qconv2d_with_k36_and_n4_on_the_card(cuda):
    """The UNet's ``conv_in`` (4 channels x 3 x 3 = K 36) and ``conv_out``
    (N 4) shapes, as modules in bf16."""
    torch.manual_seed(0)
    for cin, cout in ((4, 320), (320, 4)):
        conv = QConv2d(cin, cout, 3, padding=1).to(torch.bfloat16)
        conv.compute_dtype = torch.bfloat16
        x = torch.randn(2, cin, 8, 14, dtype=torch.bfloat16)
        with torch.no_grad():
            ref = conv(x)
            out = conv.to(cuda)(x.to(cuda))
        assert out.shape == (2, cout, 8, 14)
        assert torch.equal(out.cpu(), ref)


def test_quantize_cli_on_the_card_gives_the_cpu_file(cuda, tmp_path):
    cfg = {"model": {"_class_name": "DiTCrossviewTemporal", **TINY_DIT}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    torch.manual_seed(0)
    checkpoint.save_model_only(tmp_path / "float.pt",
                               DiTCrossviewTemporal(**TINY_DIT))
    outs = {}
    for device in ("cpu", "cuda"):
        quantize.main(["--config", str(tmp_path / "cfg.json"),
                       "--model-key", "model",
                       "--input", str(tmp_path / "float.pt"),
                       "--output", str(tmp_path / f"{device}.pt"),
                       "--device", device])
        outs[device] = checkpoint.load_model_only(tmp_path / f"{device}.pt")
    assert outs["cpu"].keys() == outs["cuda"].keys()
    for name, value in outs["cpu"].items():
        other = outs["cuda"][name]
        assert value.dtype == other.dtype, name
        if value.dtype == torch.float32:
            value, other = value.view(torch.int32), other.view(torch.int32)
        assert torch.equal(value, other), name
