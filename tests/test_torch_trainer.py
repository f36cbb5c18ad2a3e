"""gstk_torch's trainer (``train/trainer.py``) on the CPU: gstk_tpu's trainer
tests ported to the port, checkpoints across the packages, and the loop
against gstk_tpu's.

Loop parity: both trainers resume from one step-0 checkpoint written by
gstk_tpu on the fixture dataset of ``tests/test_data.py`` (the config of
``tests/test_trainer.py``, black background, one device) and train 12 steps
with two refines (step 5: opacity reset; step 10: cull and duplicate).
``densify_size_thresh`` and ``split_screen_size`` are set too high to
split, so refinement draws no noise. Required: the logged losses within
rtol 1e-3, the final alive masks equal up to ``MAX_ALIVE_FLIPS`` lanes
(a densify or cull decision whose statistic lies within rounding of its
threshold may fall either way; the count is printed), and the final
``eval_all`` PSNR within 0.05 dB.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.core.camera_opt import CameraOptConfig as JCameraOptConfig
from gstk_tpu.core.gaussians import init_scene as jinit_scene
from gstk_tpu.data.dataparser import DataparserConfig as JDataparserConfig
from gstk_tpu.models.depth import DepthConfig as JDepthConfig
from gstk_tpu.models.surface import SurfaceConfig as JSurfaceConfig
from gstk_tpu.models.vanilla import VanillaConfig as JVanillaConfig
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train.step import init_train_state as jinit_train_state
from gstk_tpu.train.trainer import Trainer as JTrainer
from gstk_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gstk_torch.configs.methods import method_configs
from gstk_torch.core.camera_opt import CameraOptConfig
from gstk_torch.core.gaussians import grow_scene
from gstk_torch.data.datamanager import CachedFrame
from gstk_torch.data.dataparser import DataparserConfig
from gstk_torch.data.synthetic import generate_synthetic_dataset
from gstk_torch.models.depth import DepthConfig
from gstk_torch.models.surface import SurfaceConfig
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.train import checkpoint as ckpt
from gstk_torch.train import trainer as trainer_mod
from gstk_torch.train.step import init_train_state
from gstk_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    _dequantize_image,
    _eval_gt,
    _quantize_cache_images,
)

from tests.test_data import _make_dataset

torch.set_num_threads(2)

MAX_ALIVE_FLIPS = 3
LOSS_RTOL = 1e-3
PSNR_ATOL = 0.05


def _kwargs(data, out, iters):
    """``tests/test_trainer.py``'s config, as keyword arguments."""
    return dict(
        data=data, output_dir=out, max_num_iterations=iters,
        steps_per_save=10, steps_per_eval_all_images=0, log_every=5,
        isect_capacity=1 << 13, raster_chunk=16,
    )


_MODEL = dict(sh_degree=1, num_downscales=1, resolution_schedule=4,
              warmup_length=2, refine_every=5, background_color="black")
_PARSER = dict(eval_mode="interval", eval_interval=3)


def _config(data, out, iters=12, **model):
    return TrainerConfig(
        **_kwargs(data, out, iters),
        model=VanillaConfig(**{**_MODEL, **model}),
        dataparser=DataparserConfig(data=data, **_PARSER),
    )


def _trained(tmp_path, iters=10, **fields):
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    cfg = dataclasses.replace(_config(data, tmp_path / "out", iters), **fields)
    trainer = Trainer(cfg, device="cpu")
    trainer.setup()
    trainer.train()
    return trainer, cfg


# the device-resident train split, or one frame uploaded per step
@pytest.mark.parametrize("cache_mb", [4096, 0])
def test_trainer_end_to_end(tmp_path, cache_mb):
    trainer, cfg = _trained(tmp_path, iters=12, device_data_cache_mb=cache_mb)
    assert (trainer._dev_cache.get(1) is None) == (cache_mb == 0)
    assert trainer.datamanager.num_train == 4
    assert ckpt.latest_checkpoint(cfg.run_dir / "ckpts") is not None
    assert int(trainer.state.step) == cfg.max_num_iterations
    assert (cfg.run_dir / "metrics.jsonl").exists()
    assert trainer._isect_window == []  # drained at the last log
    results = trainer.eval_all(step=12)
    # the eval PSNR, scored on the device, against each view's render
    # scored on the host
    frames = trainer.datamanager.eval_frames
    want = np.mean([
        -10.0 * np.log10(np.mean(
            (trainer._render_eval(f)["rgb"].numpy() - _eval_gt(f.image)) ** 2))
        for f in frames
    ])
    assert np.isfinite(results["eval_psnr"]) and np.isfinite(results["eval_ssim"])
    np.testing.assert_allclose(results["eval_psnr"], want, rtol=1e-5)


def test_trainer_resume(tmp_path):
    t1, cfg = _trained(tmp_path, iters=10)
    cfg2 = dataclasses.replace(
        cfg, max_num_iterations=14, load_dir=cfg.run_dir / "ckpts"
    )
    t2 = Trainer(cfg2, device="cpu")
    t2.setup()
    assert int(t2.state.step) == 10  # resumed
    t2.train()
    assert int(t2.state.step) == 14


def test_trainer_resume_past_densify_growth(tmp_path):
    """A checkpoint written after capacity growth resumes into a fresh
    trainer whose initial capacity is smaller: the parameters take the
    checkpoint's capacity."""
    t1, cfg = _trained(tmp_path, iters=10)
    cap1 = t1.state.scene.capacity
    grown = init_train_state(grow_scene(t1.state.scene, cap1 * 2))
    grown.step = t1.state.step
    ckpt.save_checkpoint(cfg.run_dir / "ckpts", grown, True)
    cfg2 = dataclasses.replace(
        cfg, max_num_iterations=12, load_dir=cfg.run_dir / "ckpts"
    )
    t2 = Trainer(cfg2, device="cpu")
    t2.setup()
    assert t2.state.scene.capacity == cap1 * 2
    assert int(t2.state.step) == 10
    t2.train()
    assert int(t2.state.step) == 12


def _growth_trainer(tmp_path):
    ds = generate_synthetic_dataset(
        tmp_path / "ds", n_points=200, n_views=4, img_wh=(48, 32), device="cpu"
    )
    cfg = method_configs()["gaussian-splatting"]
    cfg = dataclasses.replace(
        cfg, data=ds, output_dir=tmp_path / "out", max_num_iterations=1,
        steps_per_eval_image=0, steps_per_eval_all_images=0,
        isect_capacity=1 << 12, data_parallel="off",
        dataparser=dataclasses.replace(
            cfg.dataparser, data=ds, eval_mode="interval", eval_interval=3,
            downscale_factor=1,
        ),
    )
    tr = Trainer(cfg, device="cpu")
    tr.setup()
    return tr


def test_isect_growth_switches_to_bands(tmp_path):
    tr = _growth_trainer(tmp_path)
    # below the ceiling: the next 3-bit-mantissa bucket, >= 1.2x headroom
    n = int(0.95 * (1 << 12))
    tr._maybe_grow({"num_alive": 0, "num_intersects": n})
    assert tr.raster_cfg.isect_capacity >= 1.2 * n
    assert tr.raster_cfg.isect_capacity <= 1 << 13
    assert tr.raster_cfg.isect_capacity % 1024 == 0
    assert tr.raster_cfg.bands == 1
    # at the 2^21 ceiling bands grow instead
    tr.raster_cfg = dataclasses.replace(tr.raster_cfg, isect_capacity=1 << 21)
    tr._maybe_grow({"num_alive": 0, "num_intersects": int(0.95 * (1 << 21))})
    assert tr.raster_cfg.isect_capacity == 1 << 21
    assert tr.raster_cfg.bands == 2
    # hysteresis: a borderline per-band load keeps both bands
    tr._maybe_grow({"num_alive": 0, "num_intersects": int(0.4 * (1 << 21))})
    assert tr.raster_cfg.bands == 2
    tr._maybe_grow({"num_alive": 0, "num_intersects": int(0.2 * (1 << 21))})
    assert tr.raster_cfg.bands == 1
    # Gaussian capacity grows past 0.85 of it, moments and statistics too
    cap = tr.state.scene.capacity
    tr._maybe_grow({"num_alive": int(0.9 * cap), "num_intersects": 0})
    assert tr.state.scene.capacity == 2 * cap
    assert tr.state.adam.mu["means"].shape[0] == 2 * cap
    assert tr.state.refine.vis_counts.shape == (2 * cap,)
    assert not tr.state.scene.alive[cap:].any()
    # and saturates at max_capacity without resizing
    cap = tr.state.scene.capacity
    tr.config = dataclasses.replace(tr.config, max_capacity=cap)
    tr._maybe_grow({"num_alive": int(0.9 * cap), "num_intersects": 0})
    assert tr.state.scene.capacity == cap


def test_mid_window_isect_spike_triggers_growth(tmp_path):
    tr = _growth_trainer(tmp_path)
    cap0 = tr.raster_cfg.isect_capacity
    spike = int(1.5 * cap0)
    # device scalars, as the loop holds them
    tr._isect_window.extend(torch.tensor(float(v)) for v in
                            (100.0, 100.0, spike, 100.0))
    grown = tr._drain_isect_window({"num_alive": 0, "num_intersects": 50})
    assert grown["num_intersects"] == spike
    assert tr._isect_window == []
    tr._maybe_grow(grown)
    assert tr.raster_cfg.isect_capacity >= 1.2 * spike
    tr._isect_window.extend([10.0, 20.0])
    out = tr._drain_isect_window({"num_alive": 0, "num_intersects": 30})
    assert out["num_intersects"] == 30


def test_cache_quantization_lossless_roundtrip():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 8, 9, 3), dtype=np.uint8)
    imgs = (u8.astype(np.float32) / 255.0).astype(np.float32)
    cached = _quantize_cache_images(imgs, "cpu")
    assert cached.dtype == torch.uint8
    assert np.array_equal(_dequantize_image(cached[1]).numpy(), imgs[1])
    hdr = imgs + np.float32(1e-4)  # not exact 8-bit multiples
    cached2 = _quantize_cache_images(hdr, "cpu")
    assert cached2.dtype == torch.float32
    assert np.array_equal(_dequantize_image(cached2[0]).numpy(), hdr[0])


def _frames(n, h, w, lossless=True, seed=0, depth=False):
    """``n`` frames of 8-bit content in f32 (off the 8-bit grid when not
    ``lossless``) with masks and, with ``depth``, depths and mono scales
    and shifts, as the datamanager caches them."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.float32) / np.float32(255)
        if not lossless:
            img = img + np.float32(1e-4)
        frames.append(CachedFrame(
            image=img, fx=50.0, fy=51.0, cx=w / 2, cy=h / 2,
            c2w=np.eye(4, dtype=np.float32)[:3],
            mask=rng.uniform(size=(h, w)) < 0.8,
            depth=(rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
                   if depth else None),
            mono_scale=1.0 + 0.1 * i if depth else None,
            mono_shift=0.01 * i if depth else None))
    return frames


def _cache_trainer(tmp_path, frames, cache_mb=4096):
    """A trainer on the CPU whose train split is ``frames``."""
    cfg = dataclasses.replace(_config(tmp_path / "data", tmp_path / "out"),
                              device_data_cache_mb=cache_mb)
    trainer = Trainer(cfg, device="cpu")
    trainer.datamanager = types.SimpleNamespace(train_frames=frames)
    return trainer


@pytest.mark.parametrize("lossless", [True, False])
def test_train_cache_downscales_frame_by_frame(tmp_path, monkeypatch, lossless):
    """The d = 4 bucket equals the batched build (the whole stack quantized,
    uploaded, dequantized and downscaled by one product) and the per-frame
    path bit for bit, and every input of the build is one frame; masks and
    depths are every 4th pixel, mono scales and shifts one a frame, in the
    bucket and on the per-frame path."""
    frames = _frames(7, 64, 48, lossless, depth=True)
    down = trainer_mod.area_downscale
    seen = []

    def recorded(x, d):
        seen.append(tuple(x.shape))
        return down(x, d)

    monkeypatch.setattr(trainer_mod, "area_downscale", recorded)
    trainer = _cache_trainer(tmp_path, frames)
    cams, imgs, masks, depths, mscales, mshifts = trainer._device_train_cache(4)
    assert seen == [(64, 48, 3)] * 7  # one frame at a time
    stack = np.stack([f.image for f in frames])
    want = down(_dequantize_image(_quantize_cache_images(stack, "cpu")), 4)
    assert imgs.dtype == torch.float32 and torch.equal(imgs, want)
    for i in (0, 6):
        per_frame = trainer._frame_to_device(frames[i], 4)
        cached = trainer._train_inputs(i, frames[i], 4)
        assert torch.equal(imgs[i], per_frame[1])
        for a, b in zip(per_frame[2:], cached[2:]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(
        masks.numpy(), np.stack([f.mask[::4, ::4] for f in frames]))
    np.testing.assert_array_equal(
        depths.numpy(), np.stack([f.depth[::4, ::4] for f in frames]))
    np.testing.assert_array_equal(
        mscales.numpy(), np.float32([f.mono_scale for f in frames]))
    np.testing.assert_array_equal(
        mshifts.numpy(), np.float32([f.mono_shift for f in frames]))
    np.testing.assert_array_equal(cams.fx.numpy(), np.full(7, 12.5, np.float32))


def test_train_cache_at_full_resolution_is_the_quantized_stack(tmp_path):
    frames = _frames(3, 16, 12)
    _, imgs, *_ = _cache_trainer(tmp_path, frames)._device_train_cache(1)
    assert imgs.dtype == torch.uint8
    want = _quantize_cache_images(np.stack([f.image for f in frames]), "cpu")
    assert torch.equal(imgs, want)
    assert torch.equal(_dequantize_image(imgs[1]), torch.from_numpy(frames[1].image))


def test_train_cache_gates_on_the_build_peak(tmp_path):
    """Two frames of 256x256 with masks and a 2 MiB budget: the d = 4
    bucket (0.1 MiB) fits, but its build (a full-resolution f32 frame three
    times over, 2.25 MiB more) does not, so d = 4 takes the per-frame
    path; the d = 1 bucket (1.6 MiB, built with no downscale) is cached."""
    frames = _frames(2, 256, 256)
    shape = frames[0].image.shape
    assert trainer_mod.train_cache_bytes(2, shape, 4, True) > 2 << 20
    assert trainer_mod.train_cache_bytes(2, shape, 1, True) < 2 << 20
    trainer = _cache_trainer(tmp_path, frames, cache_mb=2)
    assert trainer._device_train_cache(1) is not None
    assert trainer._device_train_cache(4) is None
    assert list(trainer._dev_cache) == [4]  # the d = 1 bucket was dropped
    camera, gt, mask, depth, _, _ = trainer._train_inputs(1, frames[1], 4)
    assert gt.shape == (64, 64, 3) and mask.shape == (64, 64) and depth is None


def _flat(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_checkpoints_load_both_ways(tmp_path):
    # gstk_tpu -> port
    jstate = jinit_train_state(jinit_scene(jax.random.PRNGKey(0), 256,
                                           num_random=64, sh_degree=1))
    jpath = jckpt.save_checkpoint(tmp_path / "j", jstate, extras={"bands": 2})
    template = init_train_state(grow_scene(
        ckpt.load_scene(jpath, "cpu")[0], 512))  # a larger capacity pads
    tstate = ckpt.load_checkpoint(jpath, template)
    assert tstate.scene.capacity == 512
    got = ckpt.train_state_to_numpy(tstate)
    for k, v in _flat(jpath).items():
        if not k.startswith(".meta/"):
            np.testing.assert_array_equal(got[k][: len(v)] if v.ndim else got[k],
                                          v, err_msg=k)
    # port -> gstk_tpu
    trainer, cfg = _trained(tmp_path, iters=6)
    tpath = ckpt.latest_checkpoint(cfg.run_dir / "ckpts")
    cap = jckpt.peek_capacity(tpath)
    loaded = jckpt.load_checkpoint(tpath, jinit_train_state(jinit_scene(
        jax.random.PRNGKey(0), cap, num_random=8, sh_degree=1)))
    assert int(loaded.step) == 6 and jckpt.peek_meta(tpath)["bands"] == 1
    want = ckpt.train_state_to_numpy(trainer.state)
    for k, v in _flat(jckpt.save_checkpoint(tmp_path / "back", loaded)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_checkpoints_with_camera_state_load_both_ways(tmp_path):
    """``.cam_adjust`` and ``.cam_adam/*`` under gstk_tpu's keys, read and
    written by both packages; a template without the group ignores the
    keys, and a checkpoint without them leaves the template's zeros."""
    rng = np.random.default_rng(3)
    jstate = jinit_train_state(jinit_scene(jax.random.PRNGKey(0), 256,
                                           num_random=64, sh_degree=1),
                               num_cameras=4)
    jstate = jstate._replace(
        cam_adjust=jnp.asarray(rng.normal(size=(4, 6)), jnp.float32),
        cam_adam=jstate.cam_adam._replace(
            count=jnp.int32(7),
            mu={"camera_opt": jnp.asarray(rng.normal(size=(4, 6)), jnp.float32)},
            nu={"camera_opt": jnp.asarray(rng.uniform(size=(4, 6)), jnp.float32)}))
    jpath = jckpt.save_checkpoint(tmp_path / "j", jstate)
    cam_keys = {".cam_adjust", ".cam_adam/.count",
                ".cam_adam/.mu/['camera_opt']", ".cam_adam/.nu/['camera_opt']"}
    assert cam_keys <= set(_flat(jpath))
    scene = ckpt.load_scene(jpath, "cpu")[0]
    tstate = ckpt.load_checkpoint(jpath, init_train_state(scene, num_cameras=4))
    got = ckpt.train_state_to_numpy(tstate)
    assert set(got) == set(_flat(jpath))
    for k, v in _flat(jpath).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # port -> gstk_tpu, through the flat arrays and through a checkpoint
    back = jckpt.load_checkpoint(ckpt.save_checkpoint(tmp_path / "t", tstate),
                                 jstate)
    for k, v in _flat(jckpt.save_checkpoint(tmp_path / "back", back)).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    carried = ckpt.train_state_from_numpy(_flat(jpath), "cpu")
    assert torch.equal(carried.cam_adjust, tstate.cam_adjust)
    assert int(carried.cam_adam.count) == 7
    # a template without the group does not read it
    plain = ckpt.load_checkpoint(jpath, init_train_state(scene))
    assert plain.cam_adjust is None and plain.cam_adam is None
    # a checkpoint without it keeps the template's initial values
    jplain = jckpt.save_checkpoint(tmp_path / "jplain",
                                   jinit_train_state(jstate.scene))
    fresh = ckpt.load_checkpoint(jplain, init_train_state(scene, num_cameras=4))
    assert not fresh.cam_adjust.any() and int(fresh.cam_adam.count) == 0


def test_trainer_with_camera_opt_checkpoints_and_grows(tmp_path):
    """A port run with SE3 camera optimisation: one adjustment a train
    view, its checkpoint read by gstk_tpu's ``load_checkpoint``, resumed by
    the port at a grown capacity (camera state kept), and capacity growth
    keeps the camera state."""
    t1, cfg = _trained(tmp_path, iters=6, camera_opt=CameraOptConfig(mode="SE3"))
    n = t1.datamanager.num_train
    assert t1.state.cam_adjust.shape == (n, 6) and t1.state.cam_adjust.any()
    assert int(t1.state.cam_adam.count) == 6
    path = ckpt.latest_checkpoint(cfg.run_dir / "ckpts")
    want = ckpt.train_state_to_numpy(t1.state)
    loaded = jckpt.load_checkpoint(path, jinit_train_state(
        jinit_scene(jax.random.PRNGKey(0), jckpt.peek_capacity(path),
                    num_random=8, sh_degree=1), num_cameras=n))
    for k, v in _flat(jckpt.save_checkpoint(tmp_path / "j", loaded)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    cap = t1.state.scene.capacity
    grown = init_train_state(grow_scene(t1.state.scene, cap * 2), num_cameras=n)
    grown.step = t1.state.step
    grown.cam_adjust, grown.cam_adam = t1.state.cam_adjust, t1.state.cam_adam
    ckpt.save_checkpoint(cfg.run_dir / "ckpts", grown, True)
    t2 = Trainer(dataclasses.replace(cfg, max_num_iterations=8,
                                     load_dir=cfg.run_dir / "ckpts"),
                 device="cpu")
    t2.setup()
    assert t2.state.scene.capacity == cap * 2
    assert torch.equal(t2.state.cam_adjust, t1.state.cam_adjust)
    t2._maybe_grow({"num_alive": int(0.9 * cap * 2), "num_intersects": 0})
    assert t2.state.scene.capacity == cap * 4
    assert torch.equal(t2.state.cam_adjust, t1.state.cam_adjust)
    assert int(t2.state.cam_adam.count) == 6
    t2.train()
    assert int(t2.state.step) == 8 and int(t2.state.cam_adam.count) == 8


def test_train_cache_counts_depth(tmp_path):
    """The budget counts the f32 depth bucket: a budget that holds the
    images and masks of two 256x256 frames at d = 1 but not their depths
    too sends the split down the per-frame path, depth included."""
    frames = _frames(2, 256, 256, depth=True)
    shape = frames[0].image.shape
    without = trainer_mod.train_cache_bytes(2, shape, 1, True)
    with_depth = trainer_mod.train_cache_bytes(2, shape, 1, True, True)
    assert with_depth - without == 2 * 256 * 256 * 4
    assert without < 2 << 20 < with_depth
    trainer = _cache_trainer(tmp_path, frames, cache_mb=2)
    assert trainer._device_train_cache(1) is None
    camera, gt, mask, depth, scale, shift = trainer._train_inputs(1, frames[1], 1)
    np.testing.assert_array_equal(depth.numpy(), frames[1].depth)
    assert float(scale) == np.float32(1.1) and float(shift) == np.float32(0.01)


@pytest.mark.parametrize("field, value, milestone", [
    ("param_sharding", "auto", "M15"),
    ("coordinator_address", "localhost:1234", "M15"),
    ("vis", "viewer", "M16"),
])
def test_trainer_refuses_only_later_slices(tmp_path, field, value, milestone):
    """Every method and camera-opt mode passes the check; the options of
    the parallelism and viewer slices raise, naming them."""
    for method, cfg in method_configs().items():
        for mode in ("off", "SO3xR3", "SE3"):
            cfg = dataclasses.replace(cfg, camera_opt=CameraOptConfig(mode=mode))
            Trainer(cfg, device="cpu")._check_supported()
    cfg = dataclasses.replace(method_configs()["co-gs"], **{field: value})
    with pytest.raises(NotImplementedError, match=milestone):
        Trainer(cfg, device="cpu")._check_supported()


def _losses(run_dir):
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def _loop_parity(tmp_path, jmodel, tmodel, camera_opt="off"):
    """Both trainers from one gstk_tpu step-0 checkpoint on the fixture
    dataset, 12 steps each: (gstk_tpu's trainer, the port's, their final
    ``eval_all`` and their logged losses by step)."""
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    kw = dict(_kwargs(data, tmp_path / "j", 12), steps_per_save=0,
              data_parallel="off")
    jcfg = JTrainerConfig(
        **kw, model=jmodel, camera_opt=JCameraOptConfig(mode=camera_opt),
        dataparser=JDataparserConfig(data=data, **_PARSER),
    )
    j0 = JTrainer(jcfg)
    j0.setup()
    init = tmp_path / "init"
    jckpt.save_checkpoint(init, j0.state, extras=j0._ckpt_meta())

    jt = JTrainer(dataclasses.replace(jcfg, load_dir=init))
    jt.setup()
    jt.train()
    j_eval = jt.eval_all(12)

    tcfg = dataclasses.replace(
        _config(data, tmp_path / "t", 12), model=tmodel, steps_per_save=0,
        data_parallel="off", load_dir=init,
        camera_opt=CameraOptConfig(mode=camera_opt),
    )
    tt = Trainer(tcfg, device="cpu")
    tt.setup()
    assert tt.state.scene.capacity == j0.state.scene.capacity
    tt.train()
    t_eval = tt.eval_all(12)
    j_loss, t_loss = _losses(jcfg.run_dir), _losses(tcfg.run_dir)
    assert sorted(t_loss) == sorted(j_loss) == [0, 5, 10, 11]
    for s in j_loss:
        np.testing.assert_allclose(t_loss[s], j_loss[s], rtol=LOSS_RTOL,
                                   err_msg=f"loss at step {s}")
    return jt, tt, j_eval, t_eval, j_loss, t_loss


_NO_SPLIT = dict(densify_size_thresh=1e9, split_screen_size=1e9)


def test_loop_matches_jax(tmp_path):
    jt, tt, j_eval, t_eval, j_loss, t_loss = _loop_parity(
        tmp_path, JVanillaConfig(**_MODEL, **_NO_SPLIT),
        VanillaConfig(**_MODEL, **_NO_SPLIT))
    j_alive = np.asarray(jt.state.scene.alive)
    t_alive = tt.state.scene.alive.numpy()
    flips = int((j_alive != t_alive).sum())
    print(f"loop parity: alive {int(t_alive.sum())} (gstk_tpu "
          f"{int(j_alive.sum())}), {flips} alive flips; eval PSNR "
          f"{t_eval['eval_psnr']:.4f} (gstk_tpu {j_eval['eval_psnr']:.4f}); "
          f"losses {t_loss} (gstk_tpu {j_loss})")
    assert int(j_alive.sum()) != 50  # the refines changed the scene
    assert flips <= MAX_ALIVE_FLIPS
    assert abs(t_eval["eval_psnr"] - j_eval["eval_psnr"]) <= PSNR_ATOL


# the deterministic depth terms: sensor depth L1 from step 1 and the sparse
# term at step 0 (no random patch origins)
_DEPTH = dict(depth_loss_start_iteration=0, use_sparse_loss=True)
METHOD_LOOPS = {
    "co-gs_SO3xR3": (lambda: JDepthConfig(**_MODEL, **_NO_SPLIT, **_DEPTH),
                     lambda: DepthConfig(**_MODEL, **_NO_SPLIT, **_DEPTH),
                     "SO3xR3"),
    "surface-gs": (lambda: JSurfaceConfig(**_MODEL, **_NO_SPLIT),
                   lambda: SurfaceConfig(**_MODEL, **_NO_SPLIT), "off"),
}


@pytest.mark.parametrize("method", list(METHOD_LOOPS))
def test_method_loop_matches_jax(method, tmp_path):
    """co-gs (sensor depth from the fixture's depth PNGs, camera
    optimisation on) and surface-gs through both trainers: the logged
    losses within rtol 1e-3, the alive masks within ``MAX_ALIVE_FLIPS``,
    the final eval PSNR within 0.05 dB; co-gs's depth term and camera
    adjustments are live, surface-gs's means never move."""
    jmodel, tmodel, camera_opt = METHOD_LOOPS[method]
    jt, tt, j_eval, t_eval, _, _ = _loop_parity(tmp_path, jmodel(), tmodel(),
                                                camera_opt)
    j_alive = np.asarray(jt.state.scene.alive)
    t_alive = tt.state.scene.alive.numpy()
    flips = int((j_alive != t_alive).sum())
    print(f"{method} loop parity: alive {int(t_alive.sum())} (gstk_tpu "
          f"{int(j_alive.sum())}), {flips} flips; eval PSNR "
          f"{t_eval['eval_psnr']:.4f} (gstk_tpu {j_eval['eval_psnr']:.4f})")
    assert flips <= MAX_ALIVE_FLIPS
    assert abs(t_eval["eval_psnr"] - j_eval["eval_psnr"]) <= PSNR_ATOL
    rows = [json.loads(line) for line in
            (tt.config.run_dir / "metrics.jsonl").open()]
    if camera_opt != "off":
        adj, want = tt.state.cam_adjust.numpy(), np.asarray(jt.state.cam_adjust)
        assert adj.shape == (tt.datamanager.num_train, 6) and np.abs(adj).max() > 0
        np.testing.assert_allclose(adj, want, rtol=0.05,
                                   atol=0.05 * np.abs(want).max())
        assert all("camera_opt_rotation" in r for r in rows if "loss" in r)
        depth = [r["depth_l1"] for r in rows if "depth_l1" in r]
        assert depth[0] == 0.0 and all(v > 0 for v in depth[1:])  # gate
    else:
        means = tt.state.scene.means.detach().numpy()
        np.testing.assert_array_equal(means, np.asarray(jt.state.scene.means))
        init = ckpt.load_scene(tmp_path / "init" / "step-000000000.ckpt.npz",
                               "cpu")[0].means.detach().numpy()
        np.testing.assert_array_equal(means, init)
