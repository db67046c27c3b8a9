"""K5 and K6 of the port (``opendwm_tpu_torch/ops/tail_variants.py``) and its
tiling experiment (``opendwm_tpu_torch/perf/exp_tailvar.py``) against the
JAX experiment ``perf/exp_tailvar.py``.

``perf/`` is not a package, so the JAX file is loaded from its path; its
import sets the global compilation-cache options, which are restored
after it. It passes ``interpret=INTERPRET`` to ``pallas_call`` itself (a
``functools.partial(pl.pallas_call, interpret=True)`` patch would be
overridden), so the tests set the module's ``INTERPRET`` to run its Pallas
kernels in interpret mode. The port's wrappers take their plain version on
CPU tensors; the Hopper kernels are checked on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).

Tolerances: fp32 1e-5 max abs (the same arithmetic in another summation
order); bf16 2e-2 on ``|port - jax| / max(1, |jax|)``, the JAX experiment's
own bar (both round p and the output to bf16 after sums taken in another
order), and 5e-3 on ``||port - jax|| / ||jax||``: the outputs here are far
below 1, where the scaled bar is as large as they are.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from opendwm_tpu.ops import flash_tail as jax_flash_tail
from opendwm_tpu_torch import ops
from opendwm_tpu_torch.ops import tail_variants
from opendwm_tpu_torch.perf import exp_tailvar

REPO = Path(__file__).resolve().parents[1]
FP32_TOL, BF16_TOL, BF16_REL_TOL = 1e-5, 2e-2, 5e-3
B, H, D = 2, 4, 16
TILINGS = [("hpack", 1), ("hpack", 2), ("hpack", 4), ("qsplit", 128),
           ("qsplit", 256)]


@pytest.fixture(scope="module")
def jax_exp():
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "jax_exp_tailvar", REPO / "perf" / "exp_tailvar.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          cache[1])
        sys.path[:] = path
    return module


@pytest.fixture
def interpret(jax_exp, monkeypatch):
    monkeypatch.setattr(jax_exp, "INTERPRET", True)
    return jax_exp


def test_loading_the_jax_file_keeps_the_cache_options(jax_exp):
    assert jax.config.jax_compilation_cache_dir != "/tmp/jax_cache"
    assert jax.config.jax_persistent_cache_min_compile_time_secs != 5.0


def _inputs(seq):
    rng = np.random.default_rng(seq)
    return [(rng.standard_normal((B, seq, H, D)) * 0.5).astype(np.float32)
            for _ in range(3)]


def _port(kind, n, arrays, dtype):
    fn = tail_variants.tail_hpack if kind == "hpack" else \
        tail_variants.tail_qsplit
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return fn(q, k, v, D ** -0.5, n).float().numpy()


def _jax(module, kind, n, arrays, dtype):
    fn = getattr(module, f"tail_{kind}")
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrays)
    return np.asarray(fn(q, k, v, D ** -0.5, n).astype(jnp.float32))


def _scaled_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("kind,n", TILINGS)
@pytest.mark.parametrize("seq", [150, 128, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tilings_match_jax(interpret, kind, n, seq, dtype):
    """S 150 pads to 256 (bq 256 runs as is); S 128 and 20 pad to 128,
    where bq 256 is cut to 128."""
    arrays = _inputs(seq)
    got = _port(kind, n, arrays, getattr(torch, dtype))
    want = _jax(interpret, kind, n, arrays, getattr(jnp, dtype))
    assert got.shape == want.shape == (B, seq, H, D)
    if dtype == "float32":
        assert np.abs(got - want).max() <= FP32_TOL
    else:
        assert _scaled_err(got, want) <= BF16_TOL
        assert _rel_err(got, want) <= BF16_REL_TOL


@pytest.mark.parametrize("seq", [150, 20])
def test_tilings_match_jax_k1(interpret, monkeypatch, seq):
    """K5 and K6, the port's and the JAX package's, against JAX K1
    (``flash_tail._forward``, whose ``pallas_call`` takes the patch) in
    fp32: one function under three tilings."""
    arrays = _inputs(seq)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    k1 = np.asarray(jax_flash_tail._forward(
        *(jnp.asarray(a) for a in arrays), D ** -0.5))
    for kind, n in TILINGS:
        port = _port(kind, n, arrays, torch.float32)
        assert np.abs(port - k1).max() <= FP32_TOL, (kind, n)
        jax_tiling = _jax(interpret, kind, n, arrays, jnp.float32)
        assert np.abs(jax_tiling - k1).max() <= FP32_TOL, (kind, n)


@pytest.mark.parametrize("seq,bq,want", [
    (602, 256, 128), (448, 256, 256), (602, 128, 128), (150, 256, 256),
    (20, 256, 128), (640, 512, 128), (1000, 512, 512)])
def test_effective_bq_follows_the_jax_cut(seq, bq, want):
    """bq is cut by 128 until it divides S padded to a multiple of 128, as
    ``perf/exp_tailvar.py:123-124`` does; the kernel runs 128 or 256."""
    if want in (128, 256):
        assert tail_variants.effective_bq(seq, bq) == want
    else:
        with pytest.raises(ValueError, match="128- or 256-row"):
            tail_variants.effective_bq(seq, bq)


@pytest.mark.parametrize("call,error,match", [
    (lambda q: tail_variants.tail_hpack(q, q, q, 0.25, 3), ValueError,
     "divide"),
    (lambda q: tail_variants.tail_hpack(q, q, q, 0.25, 0), ValueError,
     "divide"),
    (lambda q: tail_variants.tail_qsplit(q, q, q, 0.25, 64), ValueError,
     "multiple of 128"),
    (lambda q: tail_variants.tail_qsplit(q, q, q[:, :10], 0.25, 128),
     ValueError, "shape"),
    (lambda q: tail_variants.tail_hpack(q.half(), q.half(), q.half(), 0.25,
                                        2), TypeError, "bf16 or fp32"),
    (lambda q: tail_variants.tail_qsplit(q, q.bfloat16(), q, 0.25, 128),
     TypeError, "one dtype"),
])
def test_bad_arguments_raise(call, error, match):
    q = torch.zeros(1, 20, H, D)
    with pytest.raises(error, match=match):
        call(q)


def test_wrappers_refuse_other_devices():
    t = torch.empty(1, 20, H, D, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tail_variants.tail_hpack(t, t, t, 0.25, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tail_variants.tail_qsplit(t, t, t, 0.25, 128)


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    q = torch.zeros(1, 20, H, D)
    tail_variants.tail_hpack(q, q, q, 0.25, 2)
    tail_variants.tail_qsplit(q, q, q, 0.25, 256)
    counts = ops.launch_counts()
    assert counts["tail_hpack"] == counts["tail_qsplit"] == 0
    assert counts["tail_hpack_by_nh"] == counts["tail_qsplit_by_bq"] == {}


def test_experiment_on_cpu_reports_every_variant(monkeypatch, tmp_path):
    """``--device cpu`` at tiny B/H/HD and shapes: every variant's numerics
    against the plain version, and no time (the CPU runs no kernel)."""
    monkeypatch.setattr(exp_tailvar, "B", B)
    monkeypatch.setattr(exp_tailvar, "H", H)
    monkeypatch.setattr(exp_tailvar, "HD", D)
    monkeypatch.setattr(exp_tailvar, "SHAPES", {"s150": 150, "s20": 20})
    out = tmp_path / "report" / "tailvar.json"
    exp_tailvar.main(["--device", "cpu", "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["device"] == {"platform": "cpu"}
    assert report["shape"] == f"b{B} h{H} hd{D}"
    for label, seq in (("s150", 150), ("s20", 20)):
        rows = report[label]
        assert [r["variant"] for r in rows] == list(exp_tailvar.VARIANTS)
        for r in rows:
            assert r["shape"] == [B, seq, H, D] and r["dtype"] == "bfloat16"
            assert 0.0 <= r["scaled_err"] <= exp_tailvar.ATTN_TOL
            assert 0.0 <= r["rel_err"] <= \
                exp_tailvar.REL_TOL[torch.bfloat16]
            assert r["max_abs_err"] >= 0.0 and "ms" not in r
        by_name = {r["variant"]: r for r in rows}
        assert by_name["tail_h4"]["nh"] == 4
        assert by_name["tail_q256"]["bq_run"] == (256 if seq == 150 else 128)


def test_experiment_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the experiment runs there")
    out = tmp_path / "tailvar.json"
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        exp_tailvar.main(["--out", str(out)])
    assert not out.exists()


def _padded_keys(q, k, v, scale):
    """Attends to the zero-filled keys up to S padded to 128 as well."""
    pad = -(-k.shape[1] // 128) * 128 - k.shape[1]
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v))
    return tail_variants.tail_attention_plain(q, k, v, scale)


# (variant replaced, wrong function of q, k, v, scale, S, within the scaled
# bar alone)
WRONG = {
    "doubled": ("tail_h2", lambda q, k, v, scale: 2 * tail_variants.tail_hpack(
        q, k, v, scale, 2), 20, False),
    "padded_keys": ("tail_q128", _padded_keys, 602, True),
    "two_percent": ("tail_q256", lambda q, k, v, scale: (
        1.02 * tail_variants.tail_attention_plain(q, k, v, scale).float()
    ).to(q.dtype), 150, True),
}


@pytest.mark.parametrize("case", WRONG)
def test_experiment_raises_on_a_variant_that_disagrees(monkeypatch, case):
    """A wrong variant fails the run; it is never recorded and passed. A
    kernel that attends to the padded keys, or is 2% off, stays inside the
    scaled bar at these inputs and is caught by the relative norm."""
    name, fn, seq, scaled_passes = WRONG[case]
    monkeypatch.setattr(exp_tailvar, "H", H)
    monkeypatch.setattr(exp_tailvar, "HD", D)
    wrong = dict(exp_tailvar.VARIANTS)
    wrong[name] = (wrong[name][0], fn, wrong[name][2])
    monkeypatch.setattr(exp_tailvar, "VARIANTS", wrong)
    g = torch.Generator().manual_seed(exp_tailvar.SEED)
    q, k, v = ((torch.randn(1, seq, H, D, generator=g) * 0.5)
               .to(torch.bfloat16) for _ in range(3))
    ref = tail_variants.tail_attention_plain(q, k, v, D ** -0.5)
    scaled = exp_tailvar.scaled_err(fn(q, k, v, D ** -0.5), ref)
    assert (scaled <= exp_tailvar.ATTN_TOL) == scaled_passes
    with pytest.raises(RuntimeError, match=f"{name} disagrees"):
        exp_tailvar.run(seq, f"s{seq}", "cpu", b=1)
