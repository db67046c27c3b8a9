"""The port's ``flat`` AdamW vs the JAX package's ``flat_adamw``, on the CPU.

``optimizer_config {"flat": true, "mu_dtype": ...}`` builds both sides'
optimizers from one config (with a warmup-cosine schedule, so the count at
which it is evaluated shows); 3 updates on the same numpy gradients.
Tolerances: the parameters within 1e-6 of their largest entry; fp32
moments the same; bf16 moments within one bf16 ulp of ``flat_adamw``'s
(the fp32 math of the two libraries may round to the neighbouring bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendwm_tpu.pipelines import optim as jax_optim
from opendwm_tpu_torch.pipelines import optim

SHAPES = {"body": {"kernel": (6, 5), "bias": (5,)},
          "head": {"kernel": (5, 3, 2)}}
CONFIG = {"lr": 1e-2, "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.99,
          "eps": 1e-6, "flat": True,
          "lr_scheduler": {"type": "warmup_cosine", "init_lr": 1e-3,
                           "warmup_steps": 2, "decay_steps": 6,
                           "end_lr": 1e-4}}
STEPS = 3


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        head, leaf = name.split(".")
        tree.setdefault(head, {})[leaf] = v
    return tree


def _unravel(flat: np.ndarray, like: dict) -> dict:
    """Split a ``ravel_pytree`` buffer into ``like``'s leaves."""
    out, at = {}, 0
    for name, v in _leaves(like).items():
        out[name] = flat[at:at + v.size].reshape(v.shape)
        at += v.size
    assert at == flat.size
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at ``x`` (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _run(mu_dtype: str):
    rng = np.random.default_rng(0)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in _leaves(SHAPES).items()}
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32)
              for n, v in init.items()} for _ in range(STEPS)]
    oc = dict(CONFIG, mu_dtype=mu_dtype)

    tx = jax_optim.build_optimizer(oc)
    params = jax.tree.map(jnp.asarray, _tree(init))
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, _tree(g)),
                                   state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)

    tparams = {n: torch.nn.Parameter(torch.tensor(v)) for n, v in init.items()}
    opt, schedule = optim.build_optimizer(list(tparams.values()), oc)
    for g in grads:
        for n, p in tparams.items():
            p.grad = torch.tensor(g[n])
        opt.step()
        schedule.step()
    return params, state, tparams, opt


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_flat_adamw_matches_jax(mu_dtype):
    params, state, tparams, opt = _run(mu_dtype)
    ref = _leaves(jax.tree.map(np.asarray, params))
    errs = {name: np.abs(p.detach().numpy() - ref[name]).max()
            / np.abs(ref[name]).max() for name, p in tparams.items()}
    print(f"flat AdamW {mu_dtype}: parameters {max(errs.values()):.2e} of "
          "their largest")
    for name, err in errs.items():
        assert err <= 1e-6, name

    assert int(state.count) == STEPS
    want = torch.float32 if mu_dtype == "float32" else torch.bfloat16
    for key, flat in (("exp_avg", state.mu), ("exp_avg_sq", state.nu)):
        assert flat.dtype == jnp.dtype(mu_dtype)
        ref_m = _unravel(np.asarray(flat.astype(jnp.float32)),
                         jax.tree.map(np.asarray, params))
        for name, p in tparams.items():
            m = opt.state[p][key]
            assert m.dtype == want, (key, name)
            m, r = m.float().numpy(), ref_m[name]
            if mu_dtype == "float32":
                assert np.abs(m - r).max() <= 1e-6 * np.abs(r).max()
            else:
                ulps = np.abs(m - r) / _bf16_ulp(r)
                print(f"flat AdamW bf16 {key} {name}: "
                      f"{int((ulps > 0).sum())} of {ulps.size} one ulp off")
                assert (ulps <= 1).all(), (key, name)


def test_flat_adamw_bf16_moments_survive_a_checkpoint():
    _, _, tparams, opt = _run("bfloat16")
    saved = opt.state_dict()
    fresh, _ = optim.build_optimizer(list(tparams.values()),
                                     dict(CONFIG, mu_dtype="bfloat16"))
    fresh.load_state_dict(saved)
    for p in tparams.values():
        for key in ("exp_avg", "exp_avg_sq"):
            assert fresh.state[p][key].dtype == torch.bfloat16
            assert torch.equal(fresh.state[p][key], opt.state[p][key])
        assert fresh.state[p]["step"] == STEPS


def test_flat_adamw_moment_bytes():
    """bf16 moments: 2 bytes an element, 4 a parameter entry for both."""
    _, _, tparams, opt = _run("bfloat16")
    n = sum(p.numel() for p in tparams.values())
    moment_bytes = sum(t.numel() * t.element_size()
                       for s in opt.state.values()
                       for k, t in s.items() if k.startswith("exp_avg"))
    assert moment_bytes == 4 * n


def test_missing_gradient_counts_as_zero():
    """The flat buffer holds a zero gradient for a parameter that got none:
    its moments decay and weight decay still applies."""
    p = torch.nn.Parameter(torch.ones(4))
    opt, _ = optim.build_optimizer([p], dict(CONFIG, mu_dtype="bfloat16"))
    ref = jax_optim.build_optimizer(dict(CONFIG, mu_dtype="bfloat16"))
    jp = jnp.ones(4)
    state = ref.init(jp)
    upd, _ = ref.update(jnp.zeros(4), state, jp)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp + upd),
                               rtol=1e-6)
    assert not torch.equal(p.detach(), torch.ones(4))
