"""The port's CLIP and T5 text encoders against the JAX package's, on the
CPU in fp32: the same flax params (numpy draws) loaded into both through
``convert.py``, the same token ids. Bar: 1e-3 absolute on every output
(the DiT's bar, ``test_dit_converter_parity.py``); the T5 position
buckets equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models import text_encoders as jax_te
from opendwm_tpu_torch import config
from opendwm_tpu_torch.convert import (
    clip_flax_from_state_dict,
    clip_state_dict_from_flax,
    t5_flax_from_state_dict,
    t5_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models import text_encoders as te

from torch_port_helpers import flax_text_params

TOL = 1e-3
VOCAB = 99


def clip_ids(rng, b: int, s: int, eos: int) -> np.ndarray:
    """CLIP-like ids: bos 0, words, eos, pads of 1; rows of other lengths."""
    ids = np.ones((b, s), np.int32)
    for i in range(b):
        n = int(rng.integers(1, s - 1))
        ids[i, 0] = 0
        ids[i, 1:n + 1] = rng.integers(3, VOCAB - 3, n)
        ids[i, n + 1] = eos
    return ids


def build_clip(act, proj, eos, seed=0, s=8):
    kw = dict(vocab_size=VOCAB, hidden_size=16, num_layers=3, num_heads=4,
              intermediate_size=24, act=act, eos_token_id=eos,
              projection_dim=proj)
    jax_model = jax_te.CLIPTextEncoder(**kw)
    params = flax_text_params(jax_model, (1, s), seed)
    model = te.CLIPTextEncoder(**kw).eval()
    model.load_state_dict(to_torch(clip_state_dict_from_flax(params)))
    return jax_model, params, model


def build_t5(seed=0, s=20, layers=3):
    kw = dict(vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=48,
              num_layers=layers, num_heads=4)
    jax_model = jax_te.T5TextEncoder(**kw)
    params = flax_text_params(jax_model, (1, s), seed)
    model = te.T5TextEncoder(**kw).eval()
    model.load_state_dict(to_torch(t5_state_dict_from_flax(params)))
    return jax_model, params, model


@pytest.mark.parametrize("act,proj,eos,s", [
    ("quick_gelu", None, 2, 8),
    ("gelu", 12, 2, 20),
    ("quick_gelu", 12, 97, 20),
    ("gelu_new", None, 97, 8),
])
def test_clip_matches_jax(act, proj, eos, s):
    jax_model, params, model = build_clip(act, proj, eos, s=s)
    ids = clip_ids(np.random.default_rng(1), 3, s, eos)
    last, pooled, hidden = jax_model.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        p_last, p_pooled, p_hidden = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(p_last.numpy(), np.asarray(last), atol=TOL)
    np.testing.assert_allclose(p_pooled.numpy(), np.asarray(pooled),
                               atol=TOL)
    assert p_pooled.shape[-1] == (proj or 16)
    assert len(p_hidden) == len(hidden) == 4
    for p, j in zip(p_hidden, hidden):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=TOL)


def test_clip_pooling_follows_eos_rule():
    """eos_token_id 2 pools at the largest id (legacy), another eos id at
    the first eos: the two differ on the same ids."""
    ids = torch.tensor([[0, 5, 90, 7, 1, 1]])
    _, _, legacy = build_clip("gelu", None, 2, s=6)
    _, _, by_eos = build_clip("gelu", None, 7, s=6)
    by_eos.load_state_dict(legacy.state_dict())
    with torch.no_grad():
        last, pooled, _ = legacy(ids)
        _, pooled_eos, _ = by_eos(ids)
    torch.testing.assert_close(pooled[0], last[0, 2])
    torch.testing.assert_close(pooled_eos[0], last[0, 3])


@pytest.mark.parametrize("layers", [2, 3])
def test_t5_matches_jax(layers):
    jax_model, params, model = build_t5(s=20, layers=layers)
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 20)).astype(
        np.int32)
    ref = jax_model.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64)])
def test_t5_buckets_equal_jax(num_buckets, max_distance):
    rel = np.arange(-300, 301, dtype=np.int32)
    ref = jax_te.t5_relative_position_bucket(jnp.asarray(rel), num_buckets,
                                             max_distance)
    out = te.t5_relative_position_bucket(torch.from_numpy(rel).long(),
                                         num_buckets, max_distance)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("with_t5", [True, False])
def test_sd3_prompt_embeddings_match_jax(with_t5):
    rng = np.random.default_rng(3)

    def clip_out(width, proj):
        hs = [rng.standard_normal((2, 8, width)).astype(np.float32)
              for _ in range(3)]
        return (hs[-1], rng.standard_normal((2, proj)).astype(np.float32), hs)

    out_l, out_g = clip_out(8, 8), clip_out(12, 12)
    t5 = rng.standard_normal((2, 6, 40)).astype(np.float32) if with_t5 \
        else None

    def jx(o):
        return jax.tree.map(jnp.asarray, o)

    def pt(o):
        return jax.tree.map(torch.from_numpy, o)

    ref = jax_te.sd3_prompt_embeddings(
        jx(out_l), jx(out_g), None if t5 is None else jnp.asarray(t5),
        caption_dim=40)
    out = te.sd3_prompt_embeddings(
        pt(out_l), pt(out_g), None if t5 is None else torch.from_numpy(t5),
        caption_dim=40)
    assert out[0].shape == ((2, 14, 40) if with_t5 else (2, 8, 40))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("kind", ["clip", "t5"])
def test_weight_bridge_round_trip(kind):
    """The inverse maps give back the flax tree, every leaf equal."""
    if kind == "clip":
        _, params, model = build_clip("gelu", 12, 2)
        back = clip_flax_from_state_dict(model.state_dict())
    else:
        _, params, model = build_t5()
        back = t5_flax_from_state_dict(model.state_dict())
    ref = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_config_builds_the_encoders_by_reference_name():
    clip = config.create_instance_from_config({
        "_class_name": "transformers.CLIPTextModelWithProjection",
        "vocab_size": VOCAB, "hidden_size": 8, "num_layers": 1,
        "num_heads": 2, "projection_dim": 8})
    t5 = config.create_instance_from_config({
        "_class_name": "transformers.T5EncoderModel", "vocab_size": VOCAB,
        "d_model": 8, "d_kv": 4, "d_ff": 16, "num_layers": 1,
        "num_heads": 2})
    assert isinstance(clip, te.CLIPTextEncoder)
    assert isinstance(t5, te.T5TextEncoder)


def test_bf16_encoder_holds_bf16_parameters():
    """``dtype`` bf16: bf16 parameters and outputs, close to the fp32
    model with the same weights."""
    _, _, ref = build_t5()
    model = te.T5TextEncoder(vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=48,
                             num_layers=3, num_heads=4, dtype=torch.bfloat16)
    model.load_state_dict(ref.state_dict())
    ids = torch.randint(0, VOCAB, (2, 20),
                        generator=torch.Generator().manual_seed(0))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    with torch.no_grad():
        out, want = model(ids), ref(ids)
    assert out.dtype == torch.bfloat16
    rel = (out.float() - want).norm() / want.norm()
    assert rel < 3e-2, rel
