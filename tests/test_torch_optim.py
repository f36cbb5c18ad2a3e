"""gstk_torch's Adam, schedules and moment surgery against
gstk_tpu.train.optim: identical parameters, gradients and moments in,
rtol 1e-6 (f32 rounding of the same formulas), with atol 1e-6 max|x| for
the moments, whose small entries are differences of larger terms (a norm
clip that rounds one ulp apart moves them by more than 1e-6 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.train import optim as jopt
from gstk_torch.train import optim as topt

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-12)
SHAPES = {"means": (40, 3), "features_rest": (40, 3, 3), "opacities": (40, 1),
          "scales": (40, 3)}


def _close(got, want, **kw):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), **kw)


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("max_norm", [None, 0.5])
def test_adam_steps_match_jax(rng, max_norm):
    """Three steps with dead lanes in the update mask (their gradient and
    update are zeroed, their moments decay) and fresh gradients each step."""
    cfg_kw = dict(max_norm=max_norm, extra_exp=(("scales", 1e-4, 10),))
    jcfg, tcfg = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    params = _tree(rng)
    mask = rng.uniform(size=40) < 0.8
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init_adam(jparams)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = topt.init_adam(tparams)
    # non-zero starting moments, as after earlier steps
    mu, nu = _tree(rng, 0.1), {k: np.abs(v) for k, v in _tree(rng, 0.01).items()}
    jstate = jstate._replace(mu={k: jnp.asarray(v) for k, v in mu.items()},
                             nu={k: jnp.asarray(v) for k, v in nu.items()})
    for k in SHAPES:
        tstate.mu[k].copy_(torch.from_numpy(mu[k]))
        tstate.nu[k].copy_(torch.from_numpy(nu[k]))
    for step in range(3):
        grads = _tree(rng, 0.3)
        jparams, jstate = jopt.adam_step(
            jparams, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            jnp.int32(step), jcfg, update_mask=jnp.asarray(mask),
        )
        tstate = topt.adam_step(
            tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate, torch.tensor(step, dtype=torch.int32), tcfg,
            update_mask=torch.from_numpy(mask),
        )
        assert int(tstate.count) == int(jstate.count) == step + 1
        for k in SHAPES:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       err_msg=f"{k} step {step}", **TOL)
            _close(tstate.mu[k].numpy(), np.asarray(jstate.mu[k]), err_msg=k)
            _close(tstate.nu[k].numpy(), np.asarray(jstate.nu[k]), err_msg=k)
    # dead lanes never moved
    for k in SHAPES:
        np.testing.assert_array_equal(tparams[k].numpy()[~mask], params[k][~mask])


def test_schedules_match_jax():
    steps = [0, 1, 5, 99, 100, 101, 2500, 29_999, 30_000, 45_000]
    pairs = [
        (jopt.exponential_decay(1.6e-4, 1.6e-6, 30_000),
         topt.exponential_decay(1.6e-4, 1.6e-6, 30_000)),
        (jopt.exponential_decay(1e-3, 1e-5, 3000, warmup_steps=100),
         topt.exponential_decay(1e-3, 1e-5, 3000, warmup_steps=100)),
        (jopt.multistep_decay(5e-3, (100, 2500)),
         topt.multistep_decay(5e-3, (100, 2500))),
        (jopt.cosine_decay(1e-2, 30_000, lr_final=1e-4, warmup_steps=100),
         topt.cosine_decay(1e-2, 30_000, lr_final=1e-4, warmup_steps=100)),
    ]
    for jfn, tfn in pairs:
        for s in steps:
            want = float(jfn(jnp.int32(s)))
            got = tfn(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=str(s))
    jcfg, tcfg = jopt.OptimizerConfig(), topt.OptimizerConfig()
    for group in ("means", "features_dc", "quats", "camera_opt"):
        assert tcfg.lr_for(group) == jcfg.lr_for(group)
        np.testing.assert_allclose(
            float(tcfg.schedule_for(group)(torch.tensor(700))),
            float(jcfg.schedule_for(group)(jnp.int32(700))), rtol=1e-6,
        )


def test_moment_surgery_matches_jax(rng):
    moments = {k: _tree(rng) for k in ("mu", "nu")}
    jstate = jopt.AdamState(
        count=jnp.int32(4),
        mu={k: jnp.asarray(v) for k, v in moments["mu"].items()},
        nu={k: jnp.asarray(v) for k, v in moments["nu"].items()},
    )
    tstate = topt.AdamState(
        count=torch.tensor(4, dtype=torch.int32),
        mu={k: torch.tensor(v) for k, v in moments["mu"].items()},
        nu={k: torch.tensor(v) for k, v in moments["nu"].items()},
    )
    slots = np.array([3, 7, 7, 39, 12, 2**30, 25], np.int32)
    active = np.array([True, True, False, True, False, True, True])
    jstate = jopt.zero_moments_at(jstate, jnp.asarray(slots), jnp.asarray(active))
    tstate = topt.zero_moments_at(tstate, torch.from_numpy(slots),
                                  torch.from_numpy(active))
    jstate = jopt.zero_moments_group(jstate, "opacities")
    tstate = topt.zero_moments_group(tstate, "opacities")
    for which in ("mu", "nu"):
        for k in SHAPES:
            np.testing.assert_array_equal(
                getattr(tstate, which)[k].numpy(),
                np.asarray(getattr(jstate, which)[k]), err_msg=f"{which} {k}",
            )
    assert not tstate.mu["means"][[3, 7, 39, 25]].any()
    assert tstate.mu["means"][12].all()
