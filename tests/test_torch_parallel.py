"""gstk_torch's parallel paths (``gstk_torch/parallel``, the step's
``axis_name`` and the trainer's multi-rank setup) on gloo ranks on the CPU,
against gstk_tpu's on virtual CPU devices and against the port's own
single-process results.

Each case spawns its ranks (``tests/_torch_ranks.py``), which meet at a
``file://`` rendezvous in ``tmp_path`` (the trainer case at a
``tcp://`` coordinator), and joins them with a time limit; a rank still
running then is killed and the case fails.

Tolerances:
  * the DP step against gstk_tpu's ``data_parallel_train_step`` over 2
    devices from the same weights: visibility counts exactly; Adam's first
    moments (0.1 x the averaged gradient) within rtol 5e-3, atol 1e-4
    max|m| of the group (``check_pallas_parity``'s gradient tolerance),
    parameters within rtol 5e-3 plus the two learning rates an Adam step can
    move a parameter whose gradient rounds to the other sign; the ranks'
    states equal bit for bit;
  * the Gaussian-sharded render and train step (and a refine of the
    gathered state) bit-equal to the replicated ones; with camera
    optimisation the camera group within rtol 5e-3, atol 1e-4 max|x| (its
    gradient sums over the lanes, in another order on a shard) and the
    metrics within rtol 1e-5; the sharded render
    against gstk_tpu's replicated render at the render tests' rtol 1e-3 /
    atol 1e-4;
  * the tile-sharded render on 4 ranks within rtol 1e-5 / atol 1e-6 of the
    single render and of gstk_tpu's tile-sharded render;
  * the 2x2 data x gauss mesh against the 2-way data mesh: loss rtol 1e-6,
    parameters atol 1e-6, as gstk_tpu's test holds its 2-D mesh;
  * the trainer: every rank's state equal bit for bit, the eval finite; the
    Gaussian-sharded trainer equal to the single-process trainer, also
    through refines and a capacity growth with the whole-state gather
    made to raise;
  * the sharded refine (``refine(..., mesh=)``) on 2 and 4 ranks equal to
    the replicated refine bit for bit (state, info, the generator's state
    after it), and with gstk_tpu's noise within ``test_torch_refine.py``'s
    tolerances of gstk_tpu's refine; the sharded growth equal to
    ``shard_train_state`` of the padded state bit for bit; a checkpoint
    written under sharding equal to one process's member by member (the
    zip's timestamps aside).
"""

import json
import socket
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gstk_tpu.core.gaussians import init_scene
from gstk_tpu.models.vanilla import VanillaConfig as JVanillaConfig
from gstk_tpu.models.vanilla import render_scene as jrender
from gstk_tpu.ops.projection import project_gaussians
from gstk_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gstk_tpu.parallel.mesh import DATA_AXIS, data_parallel_train_step, get_mesh
from gstk_tpu.parallel.tile_sharding import make_tile_mesh, rasterize_tile_sharded
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train.optim import OptimizerConfig as JOptimizerConfig
from gstk_tpu.train import strategy as jstrategy
from gstk_tpu.train.step import TrainState as JTrainState
from gstk_tpu.train.step import init_train_state, make_train_step
from tests._scenes import make_camera, make_gaussians
from tests._torch_ranks import spawn
from tests.test_train import H, W, _cameras, _gt_scene

JRASTER = JRasterizeConfig(chunk_size=16, isect_capacity=1 << 13)
GROUPS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities")


def _scene_arrays(scene, prefix):
    return {prefix + k: np.asarray(getattr(scene, k))
            for k in ("means", "scales", "quats", "features_dc",
                      "features_rest", "opacities", "alive")}


def _camera_arrays(cams):
    return dict(
        c2w=np.stack([np.asarray(c.c2w) for c in cams]),
        fx=float(cams[0].fx), fy=float(cams[0].fy),
        cx=float(cams[0].cx), cy=float(cams[0].cy),
    )


def _jflat(state, tmp_path):
    path = jckpt.save_checkpoint(tmp_path / "j", state)
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _same_ranks(outs, prefix):
    for k in outs[0]:
        if k.startswith(prefix):
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def _equal_states(out, got, want):
    keys = [k for k in out if k.startswith(want)]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(out[got + k[len(want):]], out[k],
                                      err_msg=k)


def _anisotropic_scene(rng):
    """gstk_tpu's test scene with anisotropic scales: with isotropic ones a
    covariance does not depend on its rotation, and the rotations' gradient
    is rounding noise in both packages."""
    scene = _gt_scene(rng)
    return scene._replace(scales=scene.scales + jnp.asarray(
        rng.uniform(-0.4, 0.4, scene.scales.shape), jnp.float32))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The "dp" case on 2 ranks, beside gstk_tpu's DP step over 2 virtual
    devices from the same state; (rank outputs, gstk_tpu's state and
    render)."""
    tmp_path = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    gt_scene = _anisotropic_scene(rng)
    cams = _cameras(2)
    jcfg = JVanillaConfig(background_color="black", sh_degree=0)
    gts = jnp.stack([jrender(gt_scene, c, H, W, sh_degree=0,
                             background=jnp.zeros(3), raster_config=JRASTER,
                             config=jcfg)["rgb"] for c in cams])
    start = gt_scene._replace(opacities=jnp.zeros_like(gt_scene.opacities))
    noisy = gt_scene._replace(features_dc=gt_scene.features_dc + jnp.asarray(
        rng.normal(0, 1.5, gt_scene.features_dc.shape), jnp.float32))
    # the SH-degree-1 scene of gstk_tpu's Gaussian-sharded render test
    pts = rng.uniform(-1.5, 1.5, (100, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (100, 3)).astype(np.float32)
    sh_scene = init_scene(jax.random.PRNGKey(0), 128, (pts, rgb), sh_degree=1)
    np.savez(tmp_path / "in.npz", gts=np.asarray(gts),
             **_camera_arrays(cams), **_scene_arrays(start, "start."),
             **_scene_arrays(noisy, "noisy."),
             **_scene_arrays(gt_scene, "gt."),
             **_scene_arrays(sh_scene, "sh."))

    step = make_train_step(jcfg, JRASTER, JOptimizerConfig(), H, W,
                           sh_degree=0, axis_name=DATA_AXIS)
    wrapped = jax.jit(data_parallel_train_step(step, get_mesh(2)))
    cam_batch = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    keys = jnp.stack([jax.random.PRNGKey(5)] * 2)
    jstate, _ = wrapped(init_train_state(start), cam_batch, gts, keys)
    jref = jrender(sh_scene, cams[0], H, W, sh_degree=1,
                   background=jnp.zeros(3), config=JVanillaConfig(sh_degree=1),
                   raster_config=JRASTER)
    return (spawn("dp", 2, tmp_path), _jflat(jstate, tmp_path),
            np.asarray(jref["rgb"]))


def test_dp_step_matches_jax(two_ranks):
    """One DP step on 2 ranks (rank r takes camera r) against gstk_tpu's DP
    step over 2 devices; both ranks hold the same state."""
    outs, want, _ = two_ranks
    _same_ranks(outs, "dp.")
    out = outs[0]
    np.testing.assert_array_equal(out["dp..refine/.vis_counts"],
                                  want[".refine/.vis_counts"])
    lr_max = max(lr for _, lr in JOptimizerConfig().lrs)
    for g in GROUPS:
        mu = want[f".adam/.mu/['{g}']"]
        np.testing.assert_allclose(
            out[f"dp..adam/.mu/['{g}']"], mu, rtol=5e-3,
            atol=1e-4 * float(np.abs(mu).max(initial=0.0)), err_msg=g)
        np.testing.assert_allclose(
            out[f"dp..scene/.{g}"], want[f".scene/.{g}"], rtol=5e-3,
            atol=2 * lr_max, err_msg=g)


def test_dp_psnr_improves(two_ranks):
    """25 DP steps from perturbed colours gain more than 2 dB, as gstk_tpu's
    test requires of its DP loop."""
    psnrs = two_ranks[0][0]["psnrs"]
    assert psnrs[-1] > psnrs[0] + 2.0, psnrs


def test_dp_threads_mono_depth_scale(two_ranks):
    """The scaled log-depth term enters the DP step's loss only with the
    mono scale and shift passed through."""
    losses = two_ranks[0][0]["mono_losses"]
    assert np.isfinite(losses).all() and losses[0] != losses[1]


def test_gauss_sharded_render_matches_replicated(two_ranks):
    outs, _, jrgb = two_ranks
    for o in outs:
        for k in ("rgb", "depth", "alpha"):
            np.testing.assert_array_equal(o[f"render_{k}"],
                                          o[f"render_ref_{k}"], err_msg=k)
    np.testing.assert_allclose(outs[0]["render_rgb"], jrgb, rtol=1e-3,
                               atol=1e-4)


def test_gauss_sharded_step_and_refine_match_replicated(two_ranks):
    """Two sharded steps (scale regulariser on, so the loss reads the
    gathered scales) and a refine of the gathered state, bit for bit."""
    for o in two_ranks[0]:
        _equal_states(o, "step.", "step_ref.")
        np.testing.assert_array_equal(o["step_metrics"], o["step_metrics_ref"])
        _equal_states(o, "refine.", "refine_ref.")


def test_gauss_sharded_camera_opt_step_matches_replicated(two_ranks):
    """Two co-gs steps with SO3xR3 camera optimisation on the Gaussian
    axis against the replicated steps
    (``tests/_torch_ranks.py::assert_cam_opt_matches``)."""
    from tests._torch_ranks import assert_cam_opt_matches

    for o in two_ranks[0]:
        assert_cam_opt_matches(o)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The "mesh4" case on 4 ranks, and gstk_tpu's tile-sharded render over
    4 devices of the same projected inputs."""
    tmp_path = tmp_path_factory.mktemp("mesh4")
    rng = np.random.default_rng(0)
    cam = make_camera(img_w=128, img_h=64)
    means, scales, quats, colors, opacities = make_gaussians(rng, 300)
    proj = project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), 1.0, jnp.asarray(quats),
        jnp.asarray(cam["viewmat"]), jnp.asarray(cam["fullmat"]),
        cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["img_h"], cam["img_w"],
    )
    args = dict(xys=proj.xys, depths=proj.depths, radii=proj.radii,
                conics=proj.conics, num_tiles_hit=proj.num_tiles_hit,
                colors=jnp.asarray(colors), opacities=jnp.asarray(opacities))
    jimg, jalpha = rasterize_tile_sharded(
        *args.values(), img_height=64, img_width=128, mesh=make_tile_mesh(4),
        background=jnp.asarray([0.1, 0.2, 0.3]),
        config=JRasterizeConfig(chunk_size=16, isect_capacity=1 << 13,
                                backend="jax"))
    gt_scene = _anisotropic_scene(rng)
    cams = _cameras(2)
    jcfg = JVanillaConfig(background_color="black", sh_degree=0)
    gts = np.stack([np.asarray(jrender(
        gt_scene, c, H, W, sh_degree=0, background=jnp.zeros(3),
        raster_config=JRASTER, config=jcfg)["rgb"]) for c in cams])
    noisy = gt_scene._replace(features_dc=gt_scene.features_dc + jnp.asarray(
        rng.normal(0, 1.0, gt_scene.features_dc.shape), jnp.float32))
    np.savez(tmp_path / "in.npz", gts=gts, **_camera_arrays(cams),
             **_scene_arrays(noisy, "noisy."),
             **{f"proj.{k}": np.asarray(v) for k, v in args.items()})
    return spawn("mesh4", 4, tmp_path), np.asarray(jimg), np.asarray(jalpha)


def test_tile_sharded_render_matches_single(four_ranks):
    outs, jimg, jalpha = four_ranks
    for o in outs:
        for got, want in (("tile_img", "single_img"),
                          ("tile_alpha", "single_alpha")):
            np.testing.assert_allclose(o[got], o[want], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["tile_img"], jimg, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["tile_alpha"], jalpha, rtol=1e-5,
                                   atol=1e-6)


def test_2d_mesh_dp_x_gauss_sharding(four_ranks):
    """Data parallelism over 2 cameras with the scene sharded over the 2
    ranks of each replica, against data parallelism with the scene
    replicated."""
    outs = four_ranks[0]
    for o in outs:
        np.testing.assert_allclose(o["mesh2d.loss"], o["mesh1d.loss"],
                                   rtol=1e-6)
        for g in GROUPS:
            np.testing.assert_allclose(o[f"mesh2d..scene/.{g}"],
                                       o[f"mesh1d..scene/.{g}"], atol=1e-6,
                                       err_msg=g)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["mesh2d..scene/.means"],
                                      outs[0]["mesh2d..scene/.means"])


def _refine_cases():
    """``test_torch_refine.py``'s cases plus three split samples and a
    cull-only step (past ``stop_split_at``): name -> (inputs, what the case
    must exercise). Every case has lanes 0-39 of 64 alive, so on 2 or 4
    ranks rank 0 holds only parents and its children land on other ranks."""
    from tests import test_torch_refine as tr

    def split3():
        scene, adam, rs, step, cfg, num_train = tr._split_dup()
        return scene, adam, rs, step, dict(cfg, n_split_samples=3), num_train

    def cull_only():
        scene, adam, rs, _, cfg, num_train = tr._cull_transparent()
        return scene, adam, rs, 10_050, cfg, num_train

    cases = dict(tr.CASES)
    cases["three_split_samples"] = (
        split3, lambda i: i["num_split"] == tr.N // 2 and i["num_dropped"] > 0)
    cases["cull_only_after_densification"] = (
        cull_only, lambda i: i["num_cull"] >= tr.N // 2
        and i["num_split"] == i["num_dup"] == 0)
    return cases


@pytest.fixture(scope="module", params=[2, 4])
def refine_ranks(request, tmp_path_factory):
    """The "refine" case on 2 and 4 ranks, every refine case's state and
    gstk_tpu's noise in its inputs; (world, rank outputs, {case: (gstk_tpu's
    scene, Adam state and info, the case's check, the state before)})."""
    from tests import test_torch_refine as tr

    world = request.param
    tmp_path = tmp_path_factory.mktemp(f"refine{world}")
    arrays, specs, jax_out = {}, [], {}
    key = jax.random.PRNGKey(0)
    for name, (make, exercised) in _refine_cases().items():
        scene, adam, rs, step, cfg_kw, num_train = make()
        jcfg = JVanillaConfig(**cfg_kw)
        noise = np.stack([np.asarray(jax.random.normal(k, (tr.CAPACITY, 3)))
                          for k in jax.random.split(key, jcfg.n_split_samples)])
        flat = _jflat(JTrainState(scene, adam, rs, jnp.int32(step)),
                      tmp_path / name)
        arrays.update({f"{name}.{k}": v for k, v in flat.items()})
        arrays[f"{name}.noise"] = noise
        specs.append((name, cfg_kw, num_train, max(tr.H, tr.W)))
        jscene, jadam, _, jinfo = jstrategy.refine(
            scene, adam, rs, jnp.int32(step), key, jcfg, num_train,
            max(tr.H, tr.W))
        jax_out[name] = (jscene, jadam,
                         {k: np.asarray(v).item() for k, v in jinfo.items()},
                         exercised, flat)
    (tmp_path / "ckpt").mkdir()
    np.savez(tmp_path / "in.npz", cases=json.dumps(specs),
             ckpt_dir=str(tmp_path / "ckpt"), **arrays)
    return world, spawn("refine", world, tmp_path), jax_out, tmp_path / "ckpt"


def _state_keys(out, prefix):
    return [k[len(prefix):] for k in out
            if k.startswith(prefix) and not k.endswith(("info", "gen"))]


def test_axis_exchange_and_gather_to_host(refine_ranks):
    """``Axis.exchange`` delivers each rank's rows for rank q to rank q, in
    rank order, with uneven counts (rank p sends p + q + 1 rows to q);
    ``Axis.gather_to_host`` gives rank 0 every rank's bool flags in rank
    order and the others nothing."""
    world, outs, _, _ = refine_ranks
    for q, o in enumerate(outs):
        want = [[p, q, i] for p in range(world) for i in range(p + q + 1)]
        np.testing.assert_array_equal(o["exchange"], want)
    want = np.concatenate([np.arange(5) % (r + 2) == 0 for r in range(world)])
    np.testing.assert_array_equal(outs[0]["gather_to_host"], want)
    assert outs[0]["gather_to_host"].dtype == bool
    assert all(o["gather_to_host"].size == 0 for o in outs[1:])


def test_sharded_refine_matches_replicated(refine_ranks):
    """Every case: the sharded refine drawing its noise from a generator
    equals the replicated refine from the same seed, bit for bit, on
    every rank: the state, the info and the generator's state after it."""
    world, outs, jax_out, _ = refine_ranks
    cap = jax_out["splits_and_dups"][4][".scene/.alive"].shape[0]
    for name, (*_, before) in jax_out.items():
        rep, shd = f"{name}.rep.", f"{name}.shd."
        keys = _state_keys(outs[0], rep)
        assert len(keys) > 20
        for o in outs:
            for k in keys:
                np.testing.assert_array_equal(o[shd + k], o[rep + k],
                                              err_msg=name + k)
            for k in ("info", "gen"):
                np.testing.assert_array_equal(o[shd + k], o[rep + k],
                                              err_msg=f"{name} {k}")
        _same_ranks(outs, f"{name}.")
        if name == "splits_and_dups":
            written = (outs[0][shd + ".scene/.alive"]
                       & ~before[".scene/.alive"])
            assert written[cap // world:].any() and written.sum() > 0


def test_sharded_refine_matches_jax(refine_ranks):
    """Every case: the sharded refine with gstk_tpu's noise against
    gstk_tpu's refine, as ``test_torch_refine.py`` holds the replicated
    refine (info and alive exact; parameters and moments within rtol 1e-6,
    atol 1e-7; the means within 1e-6 of the largest |mean|)."""
    from tests import test_torch_refine as tr

    _, outs, jax_out, _ = refine_ranks
    for name, (jscene, jadam, jinfo, exercised, _) in jax_out.items():
        o, pre = outs[0], f"{name}.jax."
        assert exercised(jinfo), (name, jinfo)
        assert list(o[pre + "info"]) == [int(jinfo[k]) for k in tr.INFO], name
        np.testing.assert_array_equal(o[pre + ".scene/.alive"],
                                      np.asarray(jscene.alive))
        means_scale = tr.RTOL * float(np.abs(np.asarray(jscene.means)).max())
        for g in GROUPS:
            tr._assert_close(f"{name} {g}", o[f"{pre}.scene/.{g}"],
                             getattr(jscene, g),
                             max(tr.ATOL, means_scale) if g == "means"
                             else tr.ATOL)
            for which in ("mu", "nu"):
                tr._assert_close(f"{name} {which} {g}",
                                 o[f"{pre}.adam/.{which}/['{g}']"],
                                 getattr(jadam, which)[g])
        for k in tr.tstrategy.RefineState._fields:
            assert not o[f"{pre}.refine/.{k}"].any(), (name, k)


def test_sharded_growth_matches_padded_state(refine_ranks):
    """``grow_train_state`` on the shards equals ``shard_train_state`` of
    the padded whole state, bit for bit on every rank: 64 -> 128 lanes (a
    doubling) and 24 -> 64 (1.5x rounded up to a power of two)."""
    _, outs, _, _ = refine_ranks
    for o in outs:
        for cap in (64, 24):
            keys = _state_keys(o, f"grow{cap}_ref.")
            assert len(keys) > 20
            for k in keys:
                np.testing.assert_array_equal(o[f"grow{cap}.{k}"],
                                              o[f"grow{cap}_ref.{k}"],
                                              err_msg=f"{cap} {k}")


def test_sharded_checkpoint_matches_one_process(refine_ranks):
    """A checkpoint written under sharding (rank 0 assembles it on its
    host) holds the members of one process's checkpoint of the whole state
    in the same order, each byte for byte; only rank 0 writes."""
    _, outs, _, ckpt_dir = refine_ranks
    assert [bool(o["ckpt_written"]) for o in outs] == [True] + [False] * (
        len(outs) - 1)
    (got,), (want,) = (list((ckpt_dir / d).glob("step-*.ckpt.npz"))
                       for d in ("sharded", "one"))
    assert got.name == want.name
    with zipfile.ZipFile(got) as zg, zipfile.ZipFile(want) as zw:
        assert zg.namelist() == zw.namelist()
        assert any("cam_adam" in n for n in zw.namelist())
        for n in zw.namelist():
            assert zg.read(n) == zw.read(n), n


def test_sharding_needs_a_capacity_the_ranks_divide(refine_ranks):
    """Sharding 31 lanes, growing to 129 lanes, and a refine whose noise
    covers 63 lanes raise on every rank."""
    for o in refine_ranks[1]:
        assert o["indivisible_raised"].tolist() == [True, True, True]


def test_grow_train_state_pads_like_grow_scene():
    """``grow_train_state`` without a mesh: the scene as ``grow_scene``
    pads it, zero moments and statistics in the new lanes, the rest kept."""
    import torch
    from gstk_torch.core.gaussians import grow_scene
    from gstk_torch.parallel.gaussian_sharding import grow_train_state
    from gstk_torch.train.checkpoint import train_state_to_numpy

    import tests._torch_ranks as ranks

    state = ranks._random_state(24, 2, num_cameras=2)
    before = {k: v.copy() for k, v in train_state_to_numpy(state).items()}
    grown = train_state_to_numpy(grow_train_state(state, 64))
    padded = grow_scene(state.scene, 64)
    for k, v in before.items():
        got = grown[k]
        if k.startswith(".scene/"):
            np.testing.assert_array_equal(
                got, getattr(padded, k[len(".scene/."):]).detach().numpy(), k)
        if got.shape != v.shape:
            assert got.shape[0] == 64
            np.testing.assert_array_equal(got[:24], v, err_msg=k)
            if not k.startswith(".scene/"):
                assert not got[24:].any(), k
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)
    with pytest.raises(ValueError, match="shrink"):
        grow_train_state(state, 16)
    assert isinstance(grow_train_state(state, 24).scene.means, torch.Tensor)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    """The "trainer" case on 2 ranks on the port's synthetic set (6 views at
    64x48, 4 train views)."""
    from gstk_torch.data.synthetic import generate_synthetic_dataset

    tmp_path = tmp_path_factory.mktemp("trainer")
    generate_synthetic_dataset(tmp_path / "ds", n_points=300, n_views=6,
                               img_wh=(64, 48), device="cpu")
    np.savez(tmp_path / "in.npz", root=str(tmp_path), tcp_port=_free_port())
    return tmp_path, spawn("trainer", 2, tmp_path)


def test_trainer_data_parallel_from_coordinator(trainer_ranks):
    """gs-train's Trainer with ``coordinator_address`` on 2 ranks: the group
    starts, data parallelism turns on, every rank ends with the same state,
    rank 0 writes the checkpoint and the eval is finite."""
    root, outs = trainer_ranks
    assert int(outs[0]["dp_world"]) == 2
    assert int(outs[0]["dp..step"]) == 6
    assert np.isfinite(outs[0]["dp_eval_psnr"])
    _same_ranks(outs, "dp.")
    assert (root / "dp" / "ds" / "gaussian-splatting" / "ckpts").exists()


def test_trainer_param_sharding_grows_like_one_process(trainer_ranks):
    """``param_sharding="auto"`` on 2 ranks from a seed cloud that fills
    most of its capacity: refines at steps 3 to 15 (densifying from 9), the
    capacity grown 512 -> 1024 after step 12, so the refine at 15 writes
    children from rank 0's parents into rank 1's new lanes, with
    ``gather_train_state`` raising on the ranks, end with the one-process
    state bit for bit; rank 0's viewer holds the last snapshot, the whole
    scene."""
    from gstk_torch.core.gaussians import FIELD_NAMES
    from gstk_torch.train.checkpoint import train_state_to_numpy

    import tests._torch_ranks as ranks

    root, outs = trainer_ranks
    _same_ranks(outs, "gauss_grow.")
    events = [m for _, m in json.loads(str(outs[0]["gauss_grow_growth"]))]
    assert any(m.startswith("Growing Gaussian capacity") for m in events)
    trainer, _ = ranks.trainer_run(root, "single_grow", iters=ranks.GROW_ITERS,
                                   model=ranks.GROW_MODEL, **ranks.GROW_TRAINER)
    assert [m for _, m in trainer.growth_events] == events
    want = train_state_to_numpy(trainer.state)
    assert want[".scene/.alive"].shape == (1024,)
    assert want[".scene/.alive"][512:].any()
    for k, v in want.items():
        np.testing.assert_array_equal(outs[0]["gauss_grow." + k], v, err_msg=k)
    for k in FIELD_NAMES:
        np.testing.assert_array_equal(outs[0][f"gauss_grow_viewer.{k}"],
                                      want[f".scene/.{k}"], err_msg=k)
    assert not any(k.startswith("gauss_grow_viewer.") for k in outs[1])


def test_trainer_param_sharding_resumes_like_one_process(trainer_ranks):
    """The sharded run resumed from the growing run's checkpoint (1024
    lanes, past the fresh 512) for 3 steps, the whole state made on each
    rank's host only and ``gather_train_state`` raising, ends with the
    state one process reaches from the same checkpoint, bit for bit."""
    from gstk_torch.train.checkpoint import train_state_to_numpy

    import tests._torch_ranks as ranks

    root, outs = trainer_ranks
    _same_ranks(outs, "gauss_resume.")
    trainer, _ = ranks.trainer_run(
        root, "single_resume", iters=ranks.GROW_ITERS + 3,
        model=ranks.GROW_MODEL, load_dir=ranks.grow_ckpts(root),
        **ranks.GROW_TRAINER)
    want = train_state_to_numpy(trainer.state)
    assert int(want[".step"]) == ranks.GROW_ITERS + 3
    assert want[".scene/.alive"].shape[0] >= 1024
    for k, v in want.items():
        np.testing.assert_array_equal(outs[0]["gauss_resume." + k], v,
                                      err_msg=k)


def test_trainer_param_sharding_matches_one_process(trainer_ranks):
    """``param_sharding="auto"`` on 2 ranks (steps, two refinements by
    gather) ends with the state the same config reaches in one process."""
    from gstk_torch.train.checkpoint import train_state_to_numpy

    import tests._torch_ranks as ranks

    root, outs = trainer_ranks
    assert int(outs[0]["gauss_world"]) == 2
    assert np.isfinite(outs[0]["gauss_eval_psnr"])
    _same_ranks(outs, "gauss.")
    trainer, _ = ranks.trainer_run(root, "single")
    for k, v in train_state_to_numpy(trainer.state).items():
        np.testing.assert_array_equal(outs[0]["gauss." + k], v, err_msg=k)


def test_gs_train_parses_parallel_flags_like_jax():
    """gs-train's data-parallel, sharding and bootstrap flags parse into the
    same config fields in both packages."""
    from gstk_tpu.configs.cli import parse_cli as jparse
    from gstk_tpu.configs.methods import method_configs as jmethods
    from gstk_torch.configs.cli import parse_cli as tparse
    from gstk_torch.configs.methods import method_configs as tmethods

    argv = ["gaussian-splatting", "--data", "ds", "--data-parallel", "off",
            "--param-sharding", "auto", "--coordinator-address",
            "10.0.0.1:1234", "--num-processes", "4", "--process-id", "3"]
    fields = ("data_parallel", "param_sharding", "coordinator_address",
              "num_processes", "process_id")
    _, want = jparse("gs-train", jmethods(), argv)
    _, got = tparse("gs-train", tmethods(), argv)
    assert ([getattr(got, f) for f in fields]
            == [getattr(want, f) for f in fields]
            == ["off", "auto", "10.0.0.1:1234", 4, 3])


def test_one_process_per_device_helpers():
    """gstk_tpu's per-host helpers on one process a device: one local
    device in any mesh, and a rank's batch and replicated state already its
    global share (identity)."""
    from gstk_torch.parallel import mesh as tmesh

    tree = {"a": np.arange(3)}
    assert tmesh.local_mesh_size(None) == 1
    assert tmesh.host_local_to_global(None, tree) is tree
    assert tmesh.replicate_global(None, tree) is tree


def test_bootstrap_without_a_group(monkeypatch):
    """No coordinator and no torchrun environment: ``initialize_distributed``
    does nothing and a mesh (or a data-parallel step) asks for a group; a
    process count without a coordinator raises; a trainer that sees several
    cards and no group tells the user to start one process per card."""
    import dataclasses

    import torch
    from gstk_torch.configs.methods import method_configs
    from gstk_torch.parallel import gaussian_sharding as tgauss
    from gstk_torch.parallel import mesh as tmesh
    from gstk_torch.parallel import tile_sharding as ttiles
    from gstk_torch.train.trainer import Trainer

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    tmesh.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert not tmesh.group_configured()
    assert tmesh.group_configured("127.0.0.1:1")
    for make in (tmesh.get_mesh, tgauss.make_gauss_mesh,
                 ttiles.make_tile_mesh):
        with pytest.raises(RuntimeError, match="process group"):
            make()
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.initialize_distributed(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        tmesh.initialize_distributed("127.0.0.1:1", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = method_configs()["gaussian-splatting"]
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        Trainer(cfg, device="cuda")._check_supported()
    Trainer(dataclasses.replace(cfg, data_parallel="off"),
            device="cuda")._check_supported()
