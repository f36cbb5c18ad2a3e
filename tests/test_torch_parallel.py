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
    Gaussian-sharded trainer equal to the single-process trainer.
"""

import socket
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
