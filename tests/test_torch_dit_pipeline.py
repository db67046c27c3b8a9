"""The port's stage-sliced flagship DiT (``opendwm_tpu_torch/parallel/
dit_pipeline.py``) against the JAX package's (``opendwm_tpu/parallel/
dit_pipeline.py``), on the CPU in fp32.

On a tiny flagship (8 layers, dual attention on the first 4, crossview on
{1, 5}, temporal on {2, 3, 6, 7}, the last block context-pre-only):
``convert_dit_params_to_stages`` of the port's DiT equals JAX's of the
same weights key for key (through ``convert.flagship_stage_state_dict_
from_flax``); the sequential stage chain equals the model (the port's, and
JAX's chain); GPipe over 2 spawned gloo ranks equals the model; the gates
reproduce the published pattern; pp 2 x tp 2 with the joint attention
ringed over tp equals the chain without the ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.models.mmdit import DiTCrossviewTemporal as JaxDiT
from opendwm_tpu.parallel import dit_pipeline as jdp
from opendwm_tpu_torch.convert import (
    dit_state_dict_from_flax,
    flagship_stage_state_dict_from_flax,
    to_torch,
)
from opendwm_tpu_torch.models.mmdit import DiTCrossviewTemporal
from opendwm_tpu_torch.parallel import dit_pipeline as tdp

import torch_dist_workers as workers
from torch_port_helpers import random_flax_params

TOL = 1e-5
MODEL = dict(
    patch_size=2, num_layers=8, attention_head_dim=8, num_attention_heads=4,
    in_channels=16, out_channels=16, joint_attention_dim=24,
    caption_projection_dim=32, pooled_projection_dim=16,
    pos_embed_max_size=16, sample_size=8, qk_norm="rms_norm",
    dual_attention_layers=(0, 1, 2, 3), enable_crossview=True,
    crossview_attention_type="rowwise", crossview_block_layers=(1, 5),
    enable_temporal=True, temporal_attention_type="pointwise",
    temporal_block_layers=(2, 3, 6, 7),
    qk_norm_on_additional_modules="rms_norm",
    perspective_modeling_type="implicit",
    projection_class_embeddings_input_dim=2816,
)
# the JAX test's tiny stage pattern (tests/test_dit_pipeline.py)
TINY = dict(num_layers=8, heads=2, head_dim=8, ctx_len=4, t=2, v=2, gh=2,
            gw=2, dual_layers=(0, 1, 2, 3, 4), crossview_layers=(1, 5),
            temporal_layers=(2, 3, 6, 7))


def _inputs(b=2, t=2, v=2, h=8, w=8):
    rng = np.random.default_rng(0)
    return {
        "sample": rng.standard_normal((b, t, v, h, w, 16)),
        "timestep": np.full((b, t, v), 500.0),
        "encoder_hidden_states": rng.standard_normal((b, t, v, 4, 24)),
        "pooled_projections": rng.standard_normal((b, t, v, 16)),
        "added_time_ids": rng.standard_normal((b, t, v, 11)),
    }


@pytest.fixture(scope="module")
def models():
    inputs = {k: v.astype(np.float32) for k, v in _inputs().items()}
    jmodel = JaxDiT(**{**MODEL, "dtype": jnp.float32})
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = random_flax_params(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(1), **jin), 1)
    state_dict = to_torch(dit_state_dict_from_flax(params, 8))
    model = DiTCrossviewTemporal(**MODEL)
    model.set_view_embedding_width(
        state_dict["view_embedding.linear_1.weight"].shape[1])
    model.load_state_dict(state_dict)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        ref = model(**tin)
        seq = tdp.pipelined_dit_forward(model, **tin, n_stages=4)
    jseq = jax.jit(lambda p, x: jdp.pipelined_dit_forward(
        jmodel, p, **x, n_stages=4))(params, jin)
    pp = workers.run_group("dit_pp_case", 2, MODEL, state_dict, tin, 2)
    tp = workers.run_group("flagship_tp_case", 4, dict(TINY, batch=2), 0,
                           2, 2, 2)
    return dict(jmodel=jmodel, params=params, model=model, ref=ref, seq=seq,
                jseq=np.asarray(jseq), pp=pp, tp=tp)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_converted_stages_equal_jax_key_for_key(models, n_stages):
    want = jdp.convert_dit_params_to_stages(models["jmodel"],
                                            models["params"],
                                            n_stages=n_stages)
    got = tdp.convert_dit_params_to_stages(models["model"],
                                           n_stages=n_stages)
    lps = 8 // n_stages
    for s in range(n_stages):
        tree = jax.tree.map(lambda a: np.asarray(a[s]), want["params"])
        ref = flagship_stage_state_dict_from_flax(tree, lps)
        assert set(got["params"]) == set(ref)
        for name, value in ref.items():
            np.testing.assert_array_equal(got["params"][name][s].numpy(),
                                          value, err_msg=name)
        for gate in ("dual", "crossview", "temporal"):
            np.testing.assert_array_equal(got["gates"][gate][s].numpy(),
                                          np.asarray(want["gates"][gate][s]))


def test_sequential_chain_equals_the_model(models):
    """The port's chain equals its DiT (the gates are exact no-ops) and
    JAX's chain."""
    assert torch.equal(models["seq"], models["ref"])
    np.testing.assert_allclose(models["seq"].numpy(), models["jseq"],
                               atol=1e-4)


def test_pp_over_two_ranks_equals_the_model(models):
    for out in models["pp"]:
        np.testing.assert_allclose(out.numpy(), models["ref"].numpy(),
                                   atol=TOL, rtol=TOL)


def test_gates_reproduce_pattern():
    gen = torch.Generator().manual_seed(0)
    _, stacked, _ = tdp.build_flagship_stages(gen, n_stages=4, batch=1,
                                              **TINY)
    _, jstacked, _ = jdp.build_flagship_stages(jax.random.PRNGKey(0),
                                               n_stages=4, batch=1, **TINY)
    for gate in ("dual", "crossview", "temporal"):
        np.testing.assert_array_equal(stacked["gates"][gate].numpy(),
                                      np.asarray(jstacked["gates"][gate]))
    dual = stacked["gates"]["dual"].reshape(-1)
    assert [i for i in range(8) if dual[i] == 1] == list(TINY["dual_layers"])
    # the flagship's own 24-layer pattern
    full = tdp._stage_gates(0, 24, tdp.FLAGSHIP_DUAL, tdp.FLAGSHIP_CROSSVIEW,
                            tdp.FLAGSHIP_TEMPORAL)
    assert int(full["dual"].sum()) == 13
    assert full["crossview"].nonzero().reshape(-1).tolist() == \
        list(jdp.FLAGSHIP_CROSSVIEW)
    assert full["temporal"].nonzero().reshape(-1).tolist() == \
        list(jdp.FLAGSHIP_TEMPORAL)


def test_pp2_tp2_ring_equals_the_chain(models):
    for rank in models["tp"]:
        np.testing.assert_allclose(rank["out"].numpy(), rank["ref"].numpy(),
                                   atol=TOL, rtol=TOL)
