"""The port's prompt encoding stages against the JAX package's, on the CPU
in fp32 (mirrors ``tests/test_text_stage.py``): tiny CLIPs and a T5 share
their flax params through ``convert.py``; both stages run in this one
process, so ``WhitespaceTokenizer``'s ``hash`` gives both the same ids.
Bar: 1e-3 absolute on every output key.
"""

import numpy as np
import pytest
import torch

from opendwm_tpu.models import text_encoders as jax_te
from opendwm_tpu.models import text_stage as jax_ts
from opendwm_tpu_torch.convert import (
    clip_state_dict_from_flax,
    t5_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models import text_encoders as te
from opendwm_tpu_torch.models import text_stage as ts

from torch_port_helpers import flax_text_params

TOL = 1e-3
DESC = [[["a car turns left", "a bus"], ["rainy street at night", ""]],
        [["two trucks", "a cyclist waits"], ["empty road", "a car"]]]


def clip_pair(hidden, proj, seed, length):
    kw = dict(vocab_size=1000, hidden_size=hidden, num_layers=2,
              num_heads=2, act="quick_gelu", eos_token_id=2,
              projection_dim=proj)
    jax_model = jax_te.CLIPTextEncoder(**kw)
    params = flax_text_params(jax_model, (1, length), seed)
    model = te.CLIPTextEncoder(**kw).eval()
    model.load_state_dict(to_torch(clip_state_dict_from_flax(params)))
    return jax_model, params, model


def assert_outputs_match(out, ref, keys):
    for key in keys:
        want = np.asarray(ref[key])
        got = out[key]
        assert tuple(got.shape) == want.shape, key
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, err_msg=key)


def test_flatten_descriptions():
    assert ts.flatten_descriptions(DESC) == jax_ts.flatten_descriptions(DESC)
    assert ts.flatten_descriptions([[["a", "b"], ["c", "d"]]]) == \
        ["a", "b", "c", "d"]
    assert ts.flatten_descriptions("one") == ["one"]


@pytest.mark.parametrize("kw", [{}, {"vocab_size": 49406, "bos": 49406,
                                     "eos": 49407, "pad": 49407}])
def test_whitespace_tokenizer_ids_equal_jax(kw):
    texts = ts.flatten_descriptions(DESC) + ["x " * 20]
    np.testing.assert_array_equal(ts.WhitespaceTokenizer(**kw)(texts, 8),
                                  jax_ts.WhitespaceTokenizer(**kw)(texts, 8))


def test_clip_stage_matches_jax():
    jax_clip, params, clip = clip_pair(16, None, 0, 8)
    tok = ts.WhitespaceTokenizer()
    batch = {"image_description": DESC}
    ref = jax_ts.CLIPTextStage(jax_clip, params, jax_ts.WhitespaceTokenizer(),
                               max_length=8)(batch)
    out = ts.CLIPTextStage(clip, tok, max_length=8)(batch)
    assert out["encoder_hidden_states"].shape == (2, 2, 2, 8, 16)
    assert out["image_description"] is DESC
    assert_outputs_match(out, ref, ("encoder_hidden_states",
                                    "uncond_encoder_hidden_states"))
    emb = out["encoder_hidden_states"]
    assert not torch.allclose(emb[0, 0, 0], emb[0, 0, 1])


@pytest.mark.parametrize("with_t5", [True, False])
def test_sd3_stage_matches_jax(with_t5):
    jax_l, p_l, clip_l = clip_pair(8, 8, 1, 8)
    jax_g, p_g, clip_g = clip_pair(12, 12, 2, 8)
    jax_t5 = t5 = p_t5 = None
    if with_t5:
        kw = dict(vocab_size=1000, d_model=40, d_kv=4, d_ff=32,
                  num_layers=2, num_heads=2)
        jax_t5 = jax_te.T5TextEncoder(**kw)
        p_t5 = flax_text_params(jax_t5, (1, 6), 3)
        t5 = te.T5TextEncoder(**kw).eval()
        t5.load_state_dict(to_torch(t5_state_dict_from_flax(p_t5)))
    jt, pt = jax_ts.WhitespaceTokenizer(), ts.WhitespaceTokenizer()
    common = dict(clip_max_length=8, t5_max_length=6, caption_dim=40)
    ref = jax_ts.SD3TextStage(jax_l, p_l, jt, jax_g, p_g, jt, t5=jax_t5,
                              t5_params=p_t5, t5_tokenizer=jt, **common)
    stage = ts.SD3TextStage(clip_l, pt, clip_g, pt, t5=t5, t5_tokenizer=pt,
                            **common)
    batch = {"image_description": DESC}
    out, want = stage(batch), ref(batch)
    tokens = 14 if with_t5 else 8
    assert out["encoder_hidden_states"].shape == (2, 2, 2, tokens, 40)
    assert out["pooled_projections"].shape == (2, 2, 2, 20)
    assert_outputs_match(out, want, (
        "encoder_hidden_states", "pooled_projections",
        "uncond_encoder_hidden_states", "uncond_pooled_projections"))


def test_stage_device_and_no_grad():
    _, _, clip = clip_pair(8, 8, 1, 8)
    stage = ts.CLIPTextStage(clip, ts.WhitespaceTokenizer(), max_length=8)
    assert stage.device == torch.device("cpu")
    out = stage({"image_description": [["a car"]]})
    assert out["encoder_hidden_states"].shape == (1, 1, 1, 8, 8)
    assert not out["encoder_hidden_states"].requires_grad
