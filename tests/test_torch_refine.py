"""gstk_torch's refinement (``train/strategy.py``) against gstk_tpu's on the
CPU, from the same state.

Each case mirrors a refine test of ``tests/test_train.py`` (64 lanes, 40
alive, SH degree 0): gstk_tpu's ``refine`` runs with the key ``k``, and the
port's with ``noise`` set to the same draws,
``stack([normal(ki, (C, 3)) for ki in split(k, n_split_samples)])``, from
the state carried over by ``train_state_from_numpy``. Required:

  * the alive masks and every ``info`` count are equal;
  * parameters and Adam moments within rtol 1e-6, atol 1e-7, except the
    means: a split child's mean is its parent's plus a rotated offset, and
    the packages' float32 ``exp``, norm and matrix product differ in the
    last bit for some inputs, so where parent and offset
    cancel the child's relative error grows; the means are held to rtol
    1e-6 of the largest ``|mean|``, the size of the terms they sum;
  * the statistics are reset to zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core.gaussians import init_scene
from gstk_tpu.models.vanilla import VanillaConfig as JVanillaConfig
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train import strategy as jstrategy
from gstk_tpu.train.optim import init_adam
from gstk_tpu.train.step import TrainState as JTrainState
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.train import checkpoint as tckpt
from gstk_torch.train import strategy as tstrategy

torch.set_num_threads(2)

H, W = 48, 64
CAPACITY, N = 64, 40
RTOL, ATOL = 1e-6, 1e-7
INFO = ("num_alive", "num_split", "num_dup", "num_cull", "num_dropped",
        "did_reset")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (N, 3)).astype(np.float32)
    scene = init_scene(jax.random.PRNGKey(1), CAPACITY, (pts, rgb), sh_degree=0)
    return scene, init_adam(scene.params())


def _stats(grad):
    full = lambda v: jnp.full((CAPACITY,), v, jnp.float32)
    return jstrategy.RefineState(xys_grad_norm=full(grad), vis_counts=full(1.0),
                                 max_2dsize=full(0.0))


def _set_scales(scene, lo, hi, value):
    scales = np.asarray(scene.scales).copy()
    scales[lo:hi] = np.log(value)
    return scene._replace(scales=jnp.asarray(scales))


def _split_dup():
    scene, adam = _inputs()
    scene = _set_scales(_set_scales(scene, 0, N // 2, 0.05), N // 2, N, 0.001)
    cfg = dict(warmup_length=0, refine_every=10, reset_alpha_every=30,
               densify_grad_thresh=1e-9, stop_split_at=10_000)
    return scene, adam, _stats(1.0), 150, cfg, 4


def _cull_transparent():
    scene, adam = _inputs()
    op = np.asarray(scene.opacities).copy()
    op[: N // 2] = -8.0
    cfg = dict(warmup_length=0, refine_every=10, reset_alpha_every=30)
    return (scene._replace(opacities=jnp.asarray(op)), adam, _stats(0.0), 150,
            cfg, 4)


def _reset_inputs():
    scene, adam = _inputs()
    scene = scene._replace(opacities=jnp.full_like(scene.opacities, 3.0))
    adam = adam._replace(
        mu={**adam.mu, "opacities": jnp.ones_like(adam.mu["opacities"])}
    )
    return scene, adam


def _opacity_reset():
    scene, adam = _reset_inputs()
    cfg = dict(warmup_length=0, refine_every=10, reset_alpha_every=3)
    return scene, adam, _stats(0.0), 10, cfg, 0


def _warmup():
    scene, adam = _inputs()
    cfg = dict(warmup_length=500, refine_every=10, reset_alpha_every=30)
    return scene, adam, _stats(10.0), 150, cfg, 4


def _no_reset_in_warmup():
    scene, adam = _reset_inputs()
    cfg = dict(warmup_length=500, refine_every=100, reset_alpha_every=30)
    return scene, adam, _stats(0.0), 100, cfg, 4


def _oversized(step, reset_alpha_every):
    def case():
        scene, adam = _inputs()
        cfg = dict(warmup_length=0, refine_every=10,
                   reset_alpha_every=reset_alpha_every,
                   densify_grad_thresh=1e-9, stop_split_at=100_000,
                   densify_size_thresh=0.01, cull_scale_thresh=0.5)
        return _set_scales(scene, 0, N, 2.0), adam, _stats(1.0), step, cfg, 4
    return case


def _children_inherit():
    scene, adam = _inputs()
    dc = np.arange(CAPACITY * 3, dtype=np.float32).reshape(-1, 3)
    scene = _set_scales(scene._replace(features_dc=jnp.asarray(dc)), 0, N, 0.001)
    adam = jax.tree.map(lambda x: jnp.full_like(x, 0.5) if x.ndim else x, adam)
    cfg = dict(warmup_length=0, refine_every=10, reset_alpha_every=30,
               densify_grad_thresh=1e-9)
    return scene, adam, _stats(1.0), 150, cfg, 4


# case -> (inputs, what the case must exercise, from gstk_tpu's info)
CASES = {
    "splits_and_dups": (_split_dup, lambda i: i["num_split"] == N // 2
                        and i["num_dup"] == N - N // 2 and i["num_dropped"] > 0),
    "culls_transparent": (_cull_transparent, lambda i: i["num_cull"] == N // 2),
    "opacity_reset": (_opacity_reset, lambda i: i["did_reset"]),
    "respects_warmup": (_warmup, lambda i: i["num_alive"] == N),
    "no_reset_during_warmup": (_no_reset_in_warmup,
                               lambda i: not i["did_reset"]),
    "culls_oversized_children": (_oversized(451, 30),
                                 lambda i: i["num_alive"] == 0),
    "places_children_before_reset": (_oversized(151, 30_000),
                                     lambda i: i["num_alive"] > 0),
    "children_inherit_adam_zeroed": (_children_inherit,
                                     lambda i: i["num_dup"] == N),
}


def _carry(scene, adam, rs, step, tmp_path):
    """The port's train state from gstk_tpu's, through its checkpoint."""
    path = jckpt.save_checkpoint(
        tmp_path, JTrainState(scene, adam, rs, jnp.int32(step))
    )
    with np.load(path) as data:
        return tckpt.train_state_from_numpy(
            {k: data[k] for k in data.files}, "cpu"
        )


def _assert_close(name, got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_refine_matches_jax(case, tmp_path):
    make, exercised = CASES[case]
    scene, adam, rs, step, cfg_kw, num_train = make()
    tstate = _carry(scene, adam, rs, step, tmp_path)
    key = jax.random.PRNGKey(0)
    jcfg = JVanillaConfig(**cfg_kw)
    noise = np.stack([np.asarray(jax.random.normal(k, (CAPACITY, 3)))
                      for k in jax.random.split(key, jcfg.n_split_samples)])

    jscene, jadam, jrs, jinfo = jstrategy.refine(
        scene, adam, rs, jnp.int32(step), key, jcfg, num_train, max(H, W)
    )
    tscene, tadam, trs, tinfo = tstrategy.refine(
        tstate.scene, tstate.adam, tstate.refine, tstate.step,
        VanillaConfig(**cfg_kw), num_train, max(H, W),
        noise=torch.from_numpy(noise),
    )
    jinfo = {k: np.asarray(v).item() for k, v in jinfo.items()}
    assert exercised(jinfo), jinfo
    assert {k: tinfo[k].item() for k in INFO} == {k: jinfo[k] for k in INFO}
    np.testing.assert_array_equal(tscene.alive.numpy(), np.asarray(jscene.alive))
    means_scale = RTOL * float(np.abs(np.asarray(jscene.means)).max())
    for g, v in tscene.params().items():
        _assert_close(g, v.detach().numpy(), getattr(jscene, g),
                      max(ATOL, means_scale) if g == "means" else ATOL)
        _assert_close(f"mu {g}", tadam.mu[g].numpy(), jadam.mu[g])
        _assert_close(f"nu {g}", tadam.nu[g].numpy(), jadam.nu[g])
    for k in tstrategy.RefineState._fields:
        assert not getattr(trs, k).any(), k
        assert not np.asarray(getattr(jrs, k)).any(), k


def test_update_stats_matches_jax():
    rng = np.random.default_rng(3)
    rs = [rng.uniform(0, 2, CAPACITY).astype(np.float32) for _ in range(3)]
    xys_grad = rng.normal(0, 1e-3, (CAPACITY, 2)).astype(np.float32)
    radii = rng.integers(0, 30, CAPACITY).astype(np.int32)
    radii[::5] = 0
    want = jstrategy.update_stats(
        jstrategy.RefineState(*map(jnp.asarray, rs)), jnp.asarray(xys_grad),
        jnp.asarray(radii), max(H, W),
    )
    got = tstrategy.update_stats(
        tstrategy.RefineState(*map(torch.from_numpy, rs)),
        torch.from_numpy(xys_grad), torch.from_numpy(radii), max(H, W),
    )
    for k in tstrategy.RefineState._fields:
        _assert_close(k, getattr(got, k).numpy(), getattr(want, k))


@pytest.mark.parametrize("step", [150, 451])  # before / past the first reset
def test_cull_mask_matches_jax(step, tmp_path):
    rng = np.random.default_rng(4)
    scene, adam = _inputs()
    scene = scene._replace(
        opacities=jnp.asarray(rng.normal(-1, 2, (CAPACITY, 1)), jnp.float32),
        scales=jnp.asarray(rng.normal(-1.5, 1, (CAPACITY, 3)), jnp.float32),
    )
    max_2dsize = rng.uniform(0, 0.3, CAPACITY).astype(np.float32)
    cfg = dict(refine_every=10, reset_alpha_every=30)
    want = np.asarray(jstrategy._cull_mask(
        scene, JVanillaConfig(**cfg), jnp.int32(step), jnp.asarray(max_2dsize)
    ))
    tstate = _carry(scene, adam, _stats(0.0), step, tmp_path)
    got = tstrategy._cull_mask(tstate.scene, VanillaConfig(**cfg),
                               tstate.step, torch.from_numpy(max_2dsize))
    assert 0 < want.sum() < N
    np.testing.assert_array_equal(got.numpy(), want)
