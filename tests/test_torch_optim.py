"""gstk_torch's Adam, schedules and moment surgery against
gstk_tpu.train.optim: identical parameters, gradients and moments in,
rtol 1e-6 (f32 rounding of the same formulas), with atol 1e-6 max|x| for
the moments, whose small entries are differences of larger terms (a norm
clip that rounds one ulp apart moves them by more than 1e-6 relative).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.train import optim as jopt
from gstk_torch import _build
from gstk_torch.core.camera_opt import CameraOptConfig
from gstk_torch.train import adam_cuda
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


SCENE_WIDTHS = {"means": 3, "scales": 3, "quats": 4, "features_dc": 3,
                "features_rest": 45, "opacities": 1}  # SH degree 3


@pytest.mark.parametrize("case", [("cuda", "auto", None, True),
                                  ("cuda", "plain", None, False),
                                  ("cuda", "auto", 0.5, True),
                                  ("cpu", "auto", None, False),
                                  ("cpu", "plain", None, False),
                                  ("cuda", "fused", None, None)])
def test_fused_dispatch_rule(case, monkeypatch):
    """adam_step launches the fused kernel for CUDA tensors under the
    "auto" backend, with a norm clip or without; "plain" or the CPU keep
    adam_step_plain; another backend name is refused. The tensors lie on
    the CPU, and the rule is shown the case's device."""
    device, backend, max_norm, fused = case
    calls = []
    monkeypatch.setattr(topt, "takes_kernels", lambda _, b: _build.takes_kernels(
        torch.device(device), b))
    monkeypatch.setattr(adam_cuda, "adam_fused",
                        lambda *a: calls.append("fused"))
    monkeypatch.setattr(topt, "adam_step_plain",
                        lambda *a: calls.append("plain"))
    params = {"means": torch.zeros(4, 3)}
    run = lambda: topt.adam_step(
        params, {"means": torch.ones(4, 3)}, topt.init_adam(params),
        torch.zeros((), dtype=torch.int32),
        topt.OptimizerConfig(max_norm=max_norm), backend=backend)
    if fused is None:
        with pytest.raises(ValueError, match="fused"):
            run()
        return
    run()
    assert calls == ["fused" if fused else "plain"]


def test_fused_path_clips_on_the_device(rng, monkeypatch):
    """With a norm clip the fused path hands the kernel one scale a group,
    min(1, max_norm / |g|) of the gradient with its dead lanes zeroed (NaN
    there reaches no norm), as adam_step_plain scales each group."""
    seen = {}
    monkeypatch.setattr(topt, "takes_kernels", lambda *_: True)
    monkeypatch.setattr(adam_cuda, "adam_fused",
                        lambda *a: seen.update(mask=a[5], clip=a[6]))
    params, grads = _tree(rng), _tree(rng, 0.3)
    mask = rng.uniform(size=40) < 0.8
    grads["opacities"] *= 1e-3  # a norm under max_norm: scale 1
    for v in grads.values():
        v[~mask] = np.nan
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    topt.adam_step(tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
                   topt.init_adam(tparams), torch.zeros((), dtype=torch.int32),
                   topt.OptimizerConfig(max_norm=0.5),
                   update_mask=torch.from_numpy(mask))
    clip = seen["clip"]
    assert clip.dtype == torch.float32 and clip.shape == (len(SHAPES),)
    want = [min(1.0, 0.5 / np.linalg.norm(np.where(
        mask.reshape((40,) + (1,) * (g.ndim - 1)), g, 0.0).astype(np.float64)))
        for g in grads.values()]
    np.testing.assert_allclose(clip.numpy(), want, rtol=1e-6)
    assert float(clip[list(SHAPES).index("opacities")]) == 1.0
    assert (clip < 1.0).sum() == len(SHAPES) - 1


@pytest.mark.parametrize("case", [("auto", None), ("plain", None),
                                  ("auto", 0.5)])
def test_cpu_adam_step_is_the_plain_twin(rng, case):
    """On the CPU adam_step is adam_step_plain bit for bit, with or without
    a clip and under either backend, and launches no kernel."""
    backend, max_norm = case
    cfg = topt.OptimizerConfig(max_norm=max_norm)
    params, mu, grads = _tree(rng), _tree(rng, 0.1), _tree(rng, 0.3)
    mask = torch.from_numpy(rng.uniform(size=40) < 0.8)
    runs = []
    before = adam_cuda.adam_fused.launches
    for fn in (functools.partial(topt.adam_step, backend=backend),
               topt.adam_step_plain):
        p = {k: torch.tensor(v) for k, v in params.items()}
        state = topt.init_adam(p)
        for k in SHAPES:
            state.mu[k].copy_(torch.from_numpy(mu[k]))
        for step in range(2):
            state = fn(p, {k: torch.from_numpy(v) for k, v in grads.items()},
                       state, torch.tensor(step, dtype=torch.int32), cfg,
                       update_mask=mask)
        runs.append((p, state))
    assert adam_cuda.adam_fused.launches == before
    (p0, s0), (p1, s1) = runs
    assert int(s0.count) == int(s1.count) == 2
    for k in SHAPES:
        for a, b in ((p0, p1), (s0.mu, s1.mu), (s0.nu, s1.nu)):
            assert torch.equal(a[k], b[k]), k


def test_group_table_of_a_scene():
    """The kernel's table for a SH-3 scene: each group's row width, element
    count and rate, the means' exponential decay, constant rates elsewhere."""
    c = 1000
    params = {k: torch.zeros((c, w) if k != "features_rest" else (c, 15, 3))
              for k, w in SCENE_WIDTHS.items()}
    cfg = topt.OptimizerConfig()
    table = adam_cuda.group_table(params, cfg)
    assert [g.name for g in table] == list(SCENE_WIDTHS)
    for g in table:
        assert g.width == SCENE_WIDTHS[g.name]
        assert g.numel == c * g.width
        assert g.lr == cfg.lr_for(g.name)
        assert g.decay == ((1.6e-6, 30_000) if g.name == "means" else None)
    assert sum(g.numel for g in table) == 59 * c


def test_group_table_of_the_camera_group():
    """The camera group as the train step builds it: (num_cameras, 6), its
    own rate and the exponential decay of its ``extra_exp``."""
    cam = CameraOptConfig(mode="SO3xR3")
    cfg = topt.OptimizerConfig(
        lrs=(("camera_opt", cam.lr),),
        extra_exp=(("camera_opt", cam.lr_final, cam.max_steps),))
    (g,) = adam_cuda.group_table({"camera_opt": torch.zeros(7, 6)}, cfg)
    assert g == adam_cuda.Group("camera_opt", 42, 6, 1e-3, (5e-5, 30_000))
    assert cfg.decay_for("means") == (cfg.means_lr_final, cfg.means_max_steps)


def test_adam_fused_refuses_cpu_tensors():
    params = {"means": torch.zeros(4, 3)}
    state = topt.init_adam(params)
    with pytest.raises(ValueError, match="CUDA"):
        adam_cuda.adam_fused(params, {"means": torch.zeros(4, 3)}, state,
                             torch.zeros((), dtype=torch.int32),
                             topt.OptimizerConfig())
