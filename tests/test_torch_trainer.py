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
import numpy as np
import pytest
import torch

from gstk_tpu.core.gaussians import init_scene as jinit_scene
from gstk_tpu.data.dataparser import DataparserConfig as JDataparserConfig
from gstk_tpu.models.vanilla import VanillaConfig as JVanillaConfig
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train.step import init_train_state as jinit_train_state
from gstk_tpu.train.trainer import Trainer as JTrainer
from gstk_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gstk_torch.configs.methods import method_configs
from gstk_torch.core.gaussians import grow_scene
from gstk_torch.data.datamanager import CachedFrame
from gstk_torch.data.dataparser import DataparserConfig
from gstk_torch.data.synthetic import generate_synthetic_dataset
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


def _frames(n, h, w, lossless=True, seed=0):
    """``n`` frames of 8-bit content in f32 (off the 8-bit grid when not
    ``lossless``) with masks, as the datamanager caches them."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.float32) / np.float32(255)
        if not lossless:
            img = img + np.float32(1e-4)
        frames.append(CachedFrame(
            image=img, fx=50.0, fy=51.0, cx=w / 2, cy=h / 2,
            c2w=np.eye(4, dtype=np.float32)[:3],
            mask=rng.uniform(size=(h, w)) < 0.8))
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
    path bit for bit, and every input of the build is one frame."""
    frames = _frames(7, 64, 48, lossless)
    down = trainer_mod.area_downscale
    seen = []

    def recorded(x, d):
        seen.append(tuple(x.shape))
        return down(x, d)

    monkeypatch.setattr(trainer_mod, "area_downscale", recorded)
    trainer = _cache_trainer(tmp_path, frames)
    cams, imgs, masks = trainer._device_train_cache(4)
    assert seen == [(64, 48, 3)] * 7  # one frame at a time
    stack = np.stack([f.image for f in frames])
    want = down(_dequantize_image(_quantize_cache_images(stack, "cpu")), 4)
    assert imgs.dtype == torch.float32 and torch.equal(imgs, want)
    for i in (0, 6):
        assert torch.equal(imgs[i], trainer._frame_to_device(frames[i], 4)[1])
    np.testing.assert_array_equal(
        masks.numpy(), np.stack([f.mask[::4, ::4] for f in frames]))
    np.testing.assert_array_equal(cams.fx.numpy(), np.full(7, 12.5, np.float32))


def test_train_cache_at_full_resolution_is_the_quantized_stack(tmp_path):
    frames = _frames(3, 16, 12)
    _, imgs, _ = _cache_trainer(tmp_path, frames)._device_train_cache(1)
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
    camera, gt, mask = trainer._train_inputs(1, frames[1], 4)
    assert gt.shape == (64, 64, 3) and mask.shape == (64, 64)


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


def _losses(run_dir):
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def test_loop_matches_jax(tmp_path):
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    no_split = dict(densify_size_thresh=1e9, split_screen_size=1e9)
    kw = dict(_kwargs(data, tmp_path / "j", 12), steps_per_save=0,
              data_parallel="off")
    jcfg = JTrainerConfig(
        **kw, model=JVanillaConfig(**_MODEL, **no_split),
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
        _config(data, tmp_path / "t", 12, **no_split), steps_per_save=0,
        data_parallel="off", load_dir=init,
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
