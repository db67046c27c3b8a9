"""K7-seg's backward: the port's plain backward with segment ids against
``jax.vjp`` of the stock Pallas flash attention with ``SegmentIds``
(interpret mode, blocks of 128), and the kernel against the plain version
on the card."""

import functools

import numpy as np
import pytest
import torch

from opendwm_tpu_torch.ops import flash_attention as fa

TOL = 1e-5
SHAPE = (1, 256, 2, 64)  # (b, s, h, d)
SCALE = 0.125


def _ids(case: str):
    """(q ids, kv ids, causal) of one case, batch 1."""
    ids = np.zeros((1, 256), np.int32)
    if case == "padded":  # the flashpad form: 200 tokens, the pads apart
        ids[:, 200:] = 1
        return ids, ids, False
    ids[0, 70:] += 1  # packed: three contiguous segments
    ids[0, 181:] += 1
    if case == "packed":
        return ids, ids, False
    if case == "causal":
        return ids, ids, True
    q_ids = ids.copy()  # "hidden": rows whose id no key has
    q_ids[0, 5::9] = 7
    return q_ids, ids, False


def _stock_grads(q, k, v, do, q_ids, kv_ids, causal):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu import flash_attention as stock

    def f(q, k, v):
        return stock.flash_attention(
            q, k, v, segment_ids=stock.SegmentIds(jnp.asarray(q_ids),
                                                  jnp.asarray(kv_ids)),
            causal=causal, sm_scale=SCALE,
            block_sizes=stock.BlockSizes(
                block_q=128, block_k_major=128, block_k=128, block_b=1,
                block_q_major_dkv=128, block_k_major_dkv=128,
                block_k_dkv=128, block_q_dkv=128, block_k_major_dq=128,
                block_k_dq=128, block_q_dq=128))

    bhsd = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v, do)]
    out, vjp = jax.vjp(f, *bhsd[:3])
    grads = vjp(bhsd[3])
    return [np.asarray(a).transpose(0, 2, 1, 3) for a in (out, *grads)]


@pytest.fixture(scope="module")
def cases():
    """Every case's stock (out, dq, dk, dv) and the port's plain ones
    (JAX is imported here: the card's machine has none)."""
    from jax.experimental import pallas as pl

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    results = {}
    try:
        for n, case in enumerate(("padded", "packed", "causal", "hidden")):
            rng = np.random.default_rng(n)
            q, k, v, do = (rng.standard_normal(SHAPE).astype(np.float32)
                           for _ in range(4))
            q_ids, kv_ids, causal = _ids(case)
            ref = _stock_grads(q, k, v, do, q_ids, kv_ids, causal)
            ids = fa.SegmentIds(torch.from_numpy(q_ids),
                                torch.from_numpy(kv_ids))
            tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
            out, lse = fa.flash_attention_forward_plain(tq, tk, tv, SCALE,
                                                        causal, ids)
            grads = fa.flash_attention_backward_plain(
                tq, tk, tv, out, lse, tdo, SCALE, causal, ids)
            # the autograd Function on CPU tensors takes the same path
            leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
            routed = fa.flash_attention(*leaves, SCALE, causal,
                                        segment_ids=ids)
            routed.backward(tdo)
            results[case] = dict(
                ref=ref, port=[out, *grads], lse=lse, q_ids=q_ids,
                routed=[routed.detach(), *(t.grad for t in leaves)])
    finally:
        mp.undo()
    return results


@pytest.mark.parametrize("case", ["padded", "packed", "causal", "hidden"])
def test_plain_backward_matches_stock_vjp(cases, case):
    """Forward and dq/dk/dv within 1e-5 of the stock kernel's vjp in fp32
    (scaled by max(1, |ref|))."""
    got = cases[case]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got["port"], got["ref"]):
        a = a.numpy().astype(np.float64)
        err = (np.abs(a - b) / np.maximum(1.0, np.abs(b))).max()
        assert a.shape == b.shape and err <= TOL, (case, name, err)


@pytest.mark.parametrize("case", ["padded", "packed", "causal", "hidden"])
def test_autograd_function_takes_the_plain_backward(cases, case):
    """``flash_attention`` with ids and a gradient on CPU tensors gives the
    plain forward and backward bit for bit."""
    got = cases[case]
    for a, b in zip(got["routed"], got["port"]):
        assert torch.equal(a, b)


def test_hidden_rows_keep_uniform_probabilities(cases):
    """A row whose id no key shares has lse = MASK_VALUE and takes the
    stock kernel's 1 / n in the backward: its dv share is dO / n on every
    key, and its output the mean of V."""
    got = cases["hidden"]
    lse = got["lse"].reshape(2, 256)
    rows = got["q_ids"][0] == 7
    assert rows.sum() == 28
    assert torch.all(lse[:, torch.from_numpy(rows)] == fa.MASK_VALUE)
    assert torch.all(lse[:, torch.from_numpy(~rows)] > -1e3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head_dim", [("float32", 64),
                                            ("bfloat16", 64),
                                            ("bfloat16", 128)])
@pytest.mark.parametrize("case", ["padded", "packed", "causal", "hidden"])
def test_kernel_matches_plain(case, dtype, head_dim):
    """The kernel's forward with ids and log-sum-exp and its backward with
    ids against the plain versions on the same inputs (bf16 at head dim 64:
    the Hopper bodies; fp32 and head dim 128: the FMA and mma.sync ones):
    fp32 to 1e-4 scaled, bf16 within 0.6% relative norm per gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    q_ids, kv_ids, causal = _ids(case)
    ids = fa.SegmentIds(torch.from_numpy(q_ids).to(dev),
                        torch.from_numpy(kv_ids).to(dev))
    g = torch.Generator(dev).manual_seed(3)
    shape = (*SHAPE[:3], head_dim)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for _ in range(4))
    fa.reset_launches()
    out, lse = fa.flash_attention_forward(q, k, v, SCALE, causal, ids)
    grads = fa.flash_attention_backward(q, k, v, out, do, lse, SCALE, causal,
                                        ids)
    assert fa.segment_backward_launches == 1
    ref_out, ref_lse = fa.flash_attention_forward_plain(q, k, v, SCALE,
                                                        causal, ids)
    ref = fa.flash_attention_backward_plain(q, k, v, out, lse, do, SCALE,
                                            causal, ids)
    for a, b in zip((out, *grads), (ref_out, *ref)):
        a, b = a.float(), b.float()
        if dtype == "float32":
            assert ((a - b).abs() / b.abs().clamp_min(1.0)).max() <= 1e-4
        else:
            assert (a - b).norm() <= 6e-3 * b.norm()
