"""The port's attention shoot-out (``opendwm_tpu_torch/perf/exp_attn602.py``)
against the JAX ``perf/exp_attn602.py``.

``perf/`` is not a package, so the JAX file is loaded from its path; its
import sets the global compilation-cache options (``:36-37``) and puts the
repo on ``sys.path``, both restored after it. Its variants reach Pallas
kernels (K1 and the stock flash attention with segment ids) through
``pl.pallas_call``, which the tests patch to run in interpret mode. The
port's wrappers take their plain versions on CPU tensors; the kernels are
checked on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).

Tolerances: fp32 1e-5 max abs (the same arithmetic in another summation
order); bf16 2e-2 on ``|port - jax| / max(1, |jax|)``, the JAX shoot-out's
own bar, and 5e-3 on ``||port - jax|| / ||jax||``: the outputs here are
~0.5 / sqrt(S), where the scaled bar is as large as they are.
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

from opendwm_tpu_torch import ops
from opendwm_tpu_torch.ops import flash_attention
from opendwm_tpu_torch.perf import exp_attn602, measure

REPO = Path(__file__).resolve().parents[1]
FP32_TOL, BF16_TOL, BF16_REL_TOL = 1e-5, 2e-2, 5e-3
B, H, D = 2, 4, 16
# port variant: JAX variant
PAIRS = {"tail": "v_tail", "plain": "v_xla", "flashpad": "v_flashpad"}


@pytest.fixture(scope="module")
def jax_exp():
    cache = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "jax_exp_attn602", REPO / "perf" / "exp_attn602.py")
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
def small_jax_exp(jax_exp, monkeypatch):
    """The JAX shoot-out at B, H, D, with its Pallas kernels in interpret
    mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    for name, value in (("B", B), ("H", H), ("HD", D)):
        monkeypatch.setattr(jax_exp, name, value)
    return jax_exp


def test_loading_the_jax_file_keeps_the_cache_options(jax_exp):
    assert jax.config.jax_compilation_cache_dir != "/tmp/jax_cache"
    assert jax.config.jax_persistent_cache_min_compile_time_secs != 5.0


def _inputs(seq):
    rng = np.random.default_rng(seq)
    return [(rng.standard_normal((B, seq, H, D)) * 0.5).astype(np.float32)
            for _ in range(3)]


def _scaled_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("variant", PAIRS)
@pytest.mark.parametrize("seq", [150, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_variants_match_jax(small_jax_exp, monkeypatch, variant, seq, dtype):
    """Each of the port's variants against the JAX one of the same name
    (``tail`` K1, ``plain`` ``v_xla``, ``flashpad`` the stock flash
    attention over S padded to 256 or 128 with the pads in segment 1), the
    JAX file's ``DT`` set to the type."""
    monkeypatch.setattr(small_jax_exp, "DT", getattr(jnp, dtype))
    arrays = _inputs(seq)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    got = exp_attn602.VARIANTS[variant](q, k, v, D ** -0.5)
    want = getattr(small_jax_exp, PAIRS[variant])(
        *(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays))
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == (B, seq, H, D)
    if dtype == "float32":
        assert np.abs(got - want).max() <= FP32_TOL
    else:
        assert _scaled_err(got, want) <= BF16_TOL
        assert _rel_err(got, want) <= BF16_REL_TOL


def test_flashpad_pads_into_segment_one():
    q = torch.zeros(2, 150, H, D)
    (qp, kp, vp), ids = exp_attn602.pad(q, q, q)
    assert qp.shape == kp.shape == vp.shape == (2, 256, H, D)
    assert ids.q is ids.kv and ids.q.dtype == torch.int32
    assert ids.q[:, :150].eq(0).all() and ids.q[:, 150:].eq(1).all()
    (qp, _, _), ids = exp_attn602.pad(q[:, :128], q[:, :128], q[:, :128])
    assert qp.shape[1] == 128 and ids.q.eq(0).all()


@pytest.mark.parametrize("seq,causal", [(602, False), (150, True)])
def test_segment_bound_counts_the_pairs_of_each_segment(seq, causal):
    """The flashpad call at S attends S^2 + pad^2 pairs per head (not the
    padded square); a query sharing no key's id attends every visible key;
    the ids add their bytes."""
    padded = -(-seq // 128) * 128
    ids = torch.zeros(2, padded, dtype=torch.int32)
    ids[:, seq:] = 1
    pad = padded - seq
    if causal:
        want = (seq * (seq + 1) + pad * (pad + 1)) // 2
    else:
        want = seq ** 2 + pad ** 2
    assert measure.segment_pairs(ids, ids, causal) == 2 * want
    hidden = ids.clone()
    hidden[0, 0] = 7  # sees key 0 alone under the causal mask, else all
    lost = 1 if causal else seq
    gained = 1 if causal else padded
    assert measure.segment_pairs(hidden, ids, causal) == \
        2 * want - lost + gained
    ms, by = measure.segment_attention_bound(ids, ids, 24, 64, causal)
    flops = 4 * 24 * 2 * want * 64
    nbytes = 2 * 4 * 2 * padded * 24 * 64 + 4 * 2 * 2 * padded
    assert ms == pytest.approx(1e3 * max(flops / measure.PEAK_BF16,
                                         nbytes / measure.PEAK_BYTES))
    assert by in ("bytes", "operations")


def test_shootout_on_cpu_reports_every_variant(monkeypatch, tmp_path):
    """``--device cpu`` at tiny B/H/HD and shapes: every variant's numerics
    against the plain attention, and no time (the CPU runs no kernel);
    nothing is written but ``--out``."""
    monkeypatch.setattr(exp_attn602, "B", B)
    monkeypatch.setattr(exp_attn602, "H", H)
    monkeypatch.setattr(exp_attn602, "HD", D)
    monkeypatch.setattr(exp_attn602, "SHAPES", {"s150": 150, "s20": 20})
    bench = REPO / "perf" / "BENCH_ATTN602.json"
    before = bench.read_bytes()
    ops.reset_launch_counts()
    out = tmp_path / "report" / "attn602.json"
    exp_attn602.main(["--device", "cpu", "--out", str(out)])
    assert bench.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["report"]
    assert [p.name for p in out.parent.iterdir()] == ["attn602.json"]
    report = json.loads(out.read_text())
    assert report["device"] == {"platform": "cpu"}
    assert report["shape"] == f"b{B} h{H} hd{D}"
    for label, seq in (("s150", 150), ("s20", 20)):
        rows = report[label]
        assert [r["variant"] for r in rows] == list(exp_attn602.VARIANTS)
        for r in rows:
            assert r["shape"] == [B, seq, H, D] and r["dtype"] == "bfloat16"
            assert 0.0 <= r["scaled_err"] <= exp_attn602.ATTN_TOL[
                torch.bfloat16]
            assert 0.0 <= r["rel_err"] <= exp_attn602.REL_TOL[torch.bfloat16]
            assert "ms" not in r
        assert rows[1]["max_abs_err"] == 0.0  # plain is the reference
    counts = ops.launch_counts()
    assert counts["flash_attention_segment"] == counts["flash_tail"] == 0


def test_shootout_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the shoot-out runs there")
    out = tmp_path / "attn602.json"
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        exp_attn602.main(["--out", str(out)])
    assert not out.exists()


def _unmasked_pads(q, k, v, scale):
    """flashpad without the segment ids: the real queries also attend to
    the zero pads."""
    (qp, kp, vp), _ = exp_attn602.pad(q, k, v)
    return flash_attention.flash_attention_plain(
        qp, kp, vp, scale)[:, :q.shape[1]]


# (variant replaced, wrong function of q, k, v, scale, S, within the scaled
# bar alone)
WRONG = {
    "doubled": ("tail", lambda q, k, v, scale: 2 * exp_attn602.v_tail(
        q, k, v, scale), 20, False),
    "unmasked_pads": ("flashpad", _unmasked_pads, 602, True),
    "two_percent": ("flashpad", lambda q, k, v, scale: (
        1.02 * exp_attn602.v_flashpad(q, k, v, scale).float()).to(q.dtype),
        150, True),
    "rows_dropped": ("flashpad", lambda q, k, v, scale: exp_attn602.v_flashpad(
        q, k, v, scale)[:, 1:], 150, None),
}


@pytest.mark.parametrize("case", WRONG)
def test_shootout_raises_on_a_variant_that_disagrees(monkeypatch, case):
    """A wrong variant fails the run (the JAX file records it as "failed"
    and goes on). Attending to the pads, or a 2% error, stays inside the
    scaled bar at these inputs and is caught by the relative norm."""
    name, fn, seq, scaled_passes = WRONG[case]
    monkeypatch.setattr(exp_attn602, "H", H)
    monkeypatch.setattr(exp_attn602, "HD", D)
    monkeypatch.setitem(exp_attn602.VARIANTS, name, fn)
    g = torch.Generator().manual_seed(exp_attn602.SEED)
    q, k, v = ((torch.randn(1, seq, H, D, generator=g) * 0.5)
               .to(torch.bfloat16) for _ in range(3))
    if scaled_passes is not None:
        ref = exp_attn602.v_plain(q, k, v, D ** -0.5)
        scaled = measure.scaled_err(fn(q, k, v, D ** -0.5), ref)
        assert (scaled <= exp_attn602.ATTN_TOL[torch.bfloat16]) == \
            scaled_passes
    with pytest.raises(RuntimeError, match=f"{name} disagrees"):
        exp_attn602.run(seq, f"s{seq}", "cpu", b=1)


def test_fp32_run_on_cpu_holds_the_fp32_bars(monkeypatch):
    monkeypatch.setattr(exp_attn602, "H", H)
    monkeypatch.setattr(exp_attn602, "HD", D)
    rows = exp_attn602.run(150, "s150", "cpu", b=1, dtype=torch.float32)
    assert [r["dtype"] for r in rows] == ["float32"] * 3
    for r in rows:
        assert r["scaled_err"] <= exp_attn602.ATTN_TOL[torch.float32]
        assert r["rel_err"] <= exp_attn602.REL_TOL[torch.float32]
