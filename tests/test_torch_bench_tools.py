"""The port's benchmark tools (``gstk_torch/tools/{bench_point,profile_step,
bench_kernels,bench_render,bench_refine,bench_sort,bench_scatter,
bench_gather}.py``) against the reference's ``bench.py`` / ``tools/``
scripts on the CPU, at small sizes.

The reference's scripts build their scenes inside ``main``; the tests run
that ``main`` with the step, the projection or the refine it calls
replaced by a stub that records its arguments (and the caller's locals)
and stops, so the reference's own draws are read, not a copy of them.

Tolerances:
  * the numpy draws of ``bench.py``'s point (through
    ``tools/profile_step.py``, the same lines with ``BENCH_CAP``),
    ``tools/bench_kernels.py``'s arrays and ``tools/bench_refine.py``'s
    inputs equal bit for bit; the DC colours, which each package computes
    from the same rgb in its own float path, within 1 ulp;
  * gstk_tpu's bench scene carried across, the port's step at 64x64
    against gstk_tpu's ``backend="jax"`` step within
    ``check_pallas_parity``'s tolerances: the render rtol 1e-3 / atol
    1e-4, the loss rtol 1e-3, the gradients (Adam's first moments after one
    step, 0.1 g) rtol 5e-3 / atol 1e-4 of each group's largest, 0.5% of a
    group allowed outside for the alpha-cutoff flips of ROADMAP Queue 3
    item 1 (as ``tests/test_torch_train_step.py``);
  * K1's and K2's inputs of ``bench_kernels`` (64x64) through the plain
    twins against ``raster_pallas`` in interpret mode: K1 rtol 1e-3 / atol
    1e-4, K2 rtol 5e-3 / atol 1e-4 of each column's largest;
  * profile_step's busy time, table and launch counts exactly on
    synthetic events; its ``--parse-only`` equal to the run's own report;
  * every microbenchmark case equal to numpy (the tools assert it).
"""

import ast
import importlib.util
import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.models import vanilla as jvan
from gstk_tpu.ops import binning as jbin
from gstk_tpu.ops import projection as jproj
from gstk_tpu.ops import raster_pallas as rp
from gstk_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train import optim as jopt
from gstk_tpu.train import step as jstep
from gstk_tpu.train import strategy as jstrat
from gstk_torch.models import vanilla as tvan
from gstk_torch.train import checkpoint as tckpt
from gstk_torch.tools import (
    K1_FLOP_PER_PAIR,
    bench_gather,
    bench_kernels,
    bench_point,
    bench_refine,
    bench_render,
    bench_scatter,
    bench_sort,
    profile_step,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RES, N, CAP, ISECT = 64, 2000, 2048, 1 << 14
PARITY = dict(rtol=1e-3, atol=1e-4)
RTOL_GRAD, MAX_OUTSIDE = 5e-3, 0.005


class _Captured(Exception):
    def __init__(self, args, caller):
        super().__init__("captured")
        self.args, self.caller = args, caller


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(monkeypatch, script: str, argv, module, attr, *, jit=False):
    """Run ``tools/<script>.py``'s ``main`` with ``module.attr`` replaced by
    a stub that raises with its arguments and its caller's locals."""
    def stub(*args, **kwargs):
        raise _Captured(args, dict(inspect.currentframe().f_back.f_locals))

    monkeypatch.setattr(module, attr, stub)
    # the reference points JAX's compile cache outside the repo: not here
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    if jit:
        monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv])
    with pytest.raises(_Captured) as got:
        _reference(script).main()
    monkeypatch.undo()
    return got.value


def _step_stub(*cfg_args, **cfg_kwargs):
    def step(state, camera, gt, key):
        raise _Captured((state, camera, gt), {})
    return step


@pytest.fixture(scope="module")
def bench_capture():
    """bench.py's point as the reference builds it (``tools/profile_step.py``
    with ``BENCH_CAP``; bench.py's own main starts a watchdog that exits the
    process): gstk_tpu's train state, camera and gt at the step."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BENCH_CAP", str(CAP))
    mp.setenv("BENCH_ISECT", str(ISECT))
    mp.setattr(jstep, "make_train_step", _step_stub)
    mp.setattr(jax.config, "update", lambda *a: None)
    mp.setattr(jax, "jit", lambda f, **kw: f)
    mp.setattr(sys, "argv", ["profile_step.py", "--res", str(RES), "--n", str(N)])
    try:
        with pytest.raises(_Captured) as got:
            _reference("profile_step").main()
    finally:
        mp.undo()
    return got.value.args


def test_bench_draws_are_bench_py(bench_capture):
    """The port's bench point holds bench.py's numpy draws; its quats come
    from a torch generator, so only they differ."""
    jstate, _, jgt = bench_capture
    d = bench_point.bench_draws(RES, N)
    js = jstate.scene
    np.testing.assert_array_equal(np.asarray(js.means)[:N], d["pts"])
    np.testing.assert_array_equal(np.asarray(js.scales)[:N], d["log_scales"])
    np.testing.assert_array_equal(np.asarray(js.opacities)[:N, 0],
                                  d["logit_opacities"])
    np.testing.assert_array_equal(np.asarray(jgt), d["gt"])
    point = bench_point.bench_point(RES, N, CAP, ISECT, "cpu")
    ts = point.scene
    for name in ("means", "scales", "opacities", "features_rest", "alive"):
        np.testing.assert_array_equal(getattr(ts, name).detach().numpy(),
                                      np.asarray(getattr(js, name)), name)
    np.testing.assert_array_max_ulp(ts.features_dc.detach().numpy(),
                                    np.asarray(js.features_dc), maxulp=1)
    assert not np.array_equal(ts.quats.detach().numpy()[:N],
                              np.asarray(js.quats)[:N])
    np.testing.assert_array_equal(point.gt.numpy(), d["gt"])
    assert (point.raster.chunk_size, point.raster.isect_capacity) == (32, ISECT)
    assert float(point.camera.fx) == 1111.0 and float(point.camera.cx) == RES / 2


def test_bench_point_defaults_are_bench_py(monkeypatch):
    for k in bench_point.BENCH_DEFAULTS:
        monkeypatch.delenv(k, raising=False)
    assert [bench_point.bench_env(k) for k in bench_point.BENCH_DEFAULTS] == [
        800, 100_000, 104 * 1024, 3 << 18]
    assert bench_point.bench_env("BENCH_CAP", profile_step.PROFILE_CAP) == 1 << 17
    monkeypatch.setenv("BENCH_N", "123")
    assert bench_point.bench_env("BENCH_N") == 123


def _outside(name, got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    print(f"{name}: {int(bad.sum())} of {bad.size} outside")
    assert bad.mean() <= MAX_OUTSIDE, (name, np.abs(got - want).max())


def test_bench_step_matches_jax(bench_capture, tmp_path):
    """gstk_tpu's bench scene carried across: one port step at 64x64
    against gstk_tpu's ``backend="jax"`` step from the same state."""
    jstate, jcamera, jgt = bench_capture
    key = jax.random.PRNGKey(0)
    jfn = jstep.make_train_step(
        jvan.VanillaConfig(sh_degree=3, background_color="black"),
        JRasterizeConfig(chunk_size=32, isect_capacity=ISECT, backend="jax"),
        jopt.OptimizerConfig(), RES, RES, sh_degree=3)
    jout = jax.jit(lambda s: jvan.render_scene(
        s.scene, jcamera, RES, RES, sh_degree=3, background=jnp.zeros(3),
        config=jvan.VanillaConfig(sh_degree=3),
        raster_config=JRasterizeConfig(chunk_size=32, isect_capacity=ISECT,
                                       backend="jax")))(jstate)
    jnext, jmetrics = jax.jit(jfn)(jstate, jcamera, jgt, key)
    path = jckpt.save_checkpoint(tmp_path / "j", jstate)
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    state = tckpt.train_state_from_numpy(flat, "cpu")
    point = bench_point.bench_point(RES, N, CAP, ISECT, "cpu")._replace(
        scene=state.scene, gt=torch.from_numpy(np.array(jgt)))
    with torch.no_grad():
        out = tvan.render_scene(point.scene, point.camera, RES, RES,
                                sh_degree=3, background=torch.zeros(3),
                                config=tvan.VanillaConfig(sh_degree=3),
                                raster_config=point.raster)
    img, jimg = out["rgb"].numpy(), np.asarray(jout["rgb"])
    bad = ~np.isclose(img, jimg, **PARITY)
    assert bad.mean() <= 0.001, np.abs(img - jimg).max()
    nxt, metrics = bench_point.make_step(point)(state, point.camera, point.gt)
    assert int(metrics["num_intersects"]) == int(jmetrics["num_intersects"]) > 0
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-3)
    for name in ("means", "scales", "quats", "features_dc", "opacities"):
        mu = nxt.adam.mu[name].numpy()
        jmu = np.asarray(jnext.adam.mu[name])
        _outside(f"first moment {name}", mu, jmu, RTOL_GRAD,
                 1e-4 * np.abs(jmu).max())


def test_kernels_scene_is_bench_kernels(monkeypatch):
    """``kernels_scene`` holds ``tools/bench_kernels.py``'s arrays bit for
    bit (read from its ``main`` as it calls the projection)."""
    got = _capture(monkeypatch, "bench_kernels", [], jproj,
                   "project_gaussians")
    ref = got.caller
    ours = bench_point.kernels_scene()
    for name in ("pts", "scales", "quats", "op", "colors", "alive",
                 "viewmat"):
        np.testing.assert_array_equal(ours[name], ref[name], name)
    np.testing.assert_array_equal(ours["fullmat"], ref["fullmat"])
    assert (ref["img_h"], ref["n"], ref["cap_n"], ref["isect_cap"], ref["ch"]) \
        == (bench_point.K_RES, bench_point.K_N, bench_point.K_CAPACITY,
            bench_point.K_ISECT, bench_point.K_CH)


@pytest.fixture(scope="module")
def kernel_case():
    """bench_kernels' inputs at 64x64 on the CPU, and gstk_tpu's binning
    of the same projection."""
    arrays = bench_point.kernels_scene(RES)
    inputs = bench_kernels.kernel_inputs(arrays, RES, ISECT, "cpu")
    xys, conics, op, colors, gids, bins, tiles = inputs["args"]
    jp = jproj.project_gaussians(
        jnp.asarray(arrays["pts"]), jnp.asarray(arrays["scales"]), 1.0,
        jnp.asarray(arrays["quats"]), jnp.asarray(arrays["viewmat"][:3]),
        jnp.asarray(arrays["fullmat"]), bench_point.FOCAL, bench_point.FOCAL,
        RES / 2, RES / 2, RES, RES)
    return inputs, jp


def test_kernel_inputs_match_jax_projection_and_binning(kernel_case):
    inputs, jp = kernel_case
    xys, conics, op, colors, gids, bins, tiles = inputs["args"]
    live = np.asarray(jp.radii) > 0
    np.testing.assert_array_equal(live, xys.abs().sum(1).numpy() > 0)
    np.testing.assert_allclose(xys.numpy(), np.asarray(jp.xys), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(conics.numpy(), np.asarray(jp.conics),
                               rtol=1e-4, atol=1e-6)
    jb = jbin.bin_gaussians(jnp.asarray(xys.numpy()),
                            jnp.asarray(np.asarray(jp.depths)),
                            jnp.asarray(np.asarray(jp.radii)),
                            jnp.asarray(np.asarray(jp.num_tiles_hit)),
                            tiles, 16, ISECT)
    np.testing.assert_array_equal(gids.numpy(), np.asarray(jb.gaussian_ids))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jb.tile_bins))
    assert inputs["num_intersects"] == int(jb.num_intersects) > 1000


def _pallas_attr(args):
    """``tools/bench_kernels.py``'s ``pack``: the sorted entry-major table."""
    xys, conics, op, colors, gids = (jnp.asarray(a.numpy()) for a in args[:5])
    n = xys.shape[0]
    base = jnp.concatenate([xys, conics, op[:, None], colors,
                            jnp.zeros((n, rp.ATTR_W - 10), jnp.float32)], 1)
    base = jnp.concatenate([base, jnp.zeros((1, rp.ATTR_W), jnp.float32)], 0)
    return base[jnp.concatenate([gids, jnp.full((rp.CHUNK,), n, jnp.int32)])]


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_kernel_inputs_through_twins_match_pallas(kernel_case, kernel):
    """K1 and K2 of bench_kernels' inputs through the plain twins against
    ``raster_pallas`` in interpret mode (the reference's pack, cotangents
    of ones as its ``ct``)."""
    inputs, _ = kernel_case
    out = bench_kernels.run_kernels(inputs)
    assert out["k1_outside"] == out["k2_outside"] == 0
    assert out["k1_max_abs_err"] == out["k2_max_abs_err"] == 0.0  # CPU: the twins
    args = inputs["args"]
    tiles = args[6]
    attr = _pallas_attr(args)
    bins = jnp.asarray(args[5].numpy())
    packed = rp.composite_tiles_fwd(attr, bins, tiles, 16, ch=4, interpret=True)
    if kernel == "fwd":
        np.testing.assert_allclose(
            out["acc"].numpy(), np.asarray(packed[:, 0:4, :]).transpose(0, 2, 1),
            **PARITY)
        np.testing.assert_allclose(out["final_t"].numpy(),
                                   np.asarray(packed[:, 4, :]), **PARITY)
        return
    ct = jnp.zeros_like(packed).at[:, 0:5, :].set(1.0)
    g_blk, side = rp.composite_tiles_bwd(attr, bins, packed, ct, tiles, 16,
                                         ch=4, interpret=True)
    g_blk = g_blk.at[bins[:, 0] // rp.CHUNK].add(side, mode="drop")
    rows = np.asarray(g_blk).transpose(0, 2, 1).reshape(-1, g_blk.shape[1])
    want = rows[:ISECT, :10]
    got = out["gout"].numpy()
    scale = np.abs(want).max(0, keepdims=True)
    bad = np.abs(got - want) > 1e-4 * scale + 5e-3 * np.abs(want)
    assert not bad.any(), (int(bad.sum()), np.abs(got - want).max())
    assert np.abs(want).max() > 0


def test_bench_kernels_cpu_run():
    res = bench_kernels.main(["--device", "cpu", "--res", "48", "--isect",
                              "8192"])
    assert res["k1_outside"] == res["k2_outside"] == 0
    assert res["pairs"] >= res["kept_pairs"] > 0
    nbytes, ops = res["k1_work"]
    assert ops == res["pairs"] * K1_FLOP_PER_PAIR
    with pytest.raises(SystemExit, match="runs on the card"):
        bench_kernels.main(["--device", "cpu", "--sweep"])


def test_sweep_tiles_composite_every_entry():
    """The sweep's synthetic tiles (at their smallest tile count) keep
    every entry of every pixel: no pixel stops before its range ends."""
    inputs = bench_kernels.sweep_inputs(2048, "cpu")
    xys, conics, op, colors, gids, bins, tiles = inputs["args"]
    keep = 8 * 2048  # the first 8 tiles
    sub = (xys[:keep], conics[:keep], op[:keep], colors[:keep], gids[:keep],
           bins[:8], (8, 1))
    from gstk_torch.ops.raster_cuda import composite_tiles_bwd_plain
    acc, final_t, visited = bench_kernels.composite_tiles_fwd_plain(*sub)
    assert (visited == 2048).all() and (final_t > 1e-4).all()
    _, kept = composite_tiles_bwd_plain(*sub[:6], acc, final_t,
                                        torch.ones_like(acc),
                                        torch.ones_like(final_t), (8, 1))
    assert (kept == 2048).all()


# -- profile_step -----------------------------------------------------------

def test_busy_is_the_union_of_spans():
    assert profile_step.busy_us([(0, 10), (5, 10), (30, 5), (31, 1)]) == 20
    assert profile_step.busy_us([]) == 0


def _trace():
    k = lambda name, ts, dur, corr: {"ph": "X", "cat": "kernel", "name": name,
                                     "ts": ts, "dur": dur,
                                     "args": {"correlation": corr}}
    call = lambda name, corr: {"ph": "X", "cat": "cuda_runtime", "name": name,
                               "ts": 0, "dur": 1, "args": {"correlation": corr}}
    return {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": profile_step.WINDOW,
         "ts": 0, "dur": 1000},
        # a CPU op carrying its kernel's device time must not count
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 500},
        k("void composite_fwd_kernel<4>(float const*)", 10, 100, 1),
        k("void composite_fwd_kernel<4>(float const*)", 200, 100, 2),
        k("void segment_sum_kernel(int)", 300, 50, 3),
        k("elementwise_add", 320, 50, 4),  # overlaps the last one by 30
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 500,
         "dur": 20, "args": {"correlation": 5}},
        call("cudaLaunchKernel", 1), call("cudaLaunchKernel", 2),
        call("cudaLaunchKernel", 4), call("cudaMemcpyAsync", 5),
        call("cudaStreamSynchronize", 6),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 0},
    ]}


def test_parse_counts_device_events_only():
    meta = {"steps": 2, "step_ms": 0.5,
            "launches_made": {"composite_tiles_fwd": 2, "segment_sum_sorted": 1}}
    rep = profile_step.parse(_trace(), meta, top=2)
    assert rep["device_events"] == 5
    assert rep["device_busy_ms"] == pytest.approx((100 + 100 + 70 + 20) / 1e3)
    assert rep["window_ms"] == 1.0
    assert rep["idle_share"] == pytest.approx(1 - 0.29)
    assert rep["step_idle_share"] == pytest.approx(1 - 0.145 / 0.5)
    assert rep["launch_calls"] == 4 and rep["device_events_matched"] == 4
    rows = rep["table"]["rows"]
    assert rows[0] == [0.1, 1.0, "void composite_fwd_kernel<4>(float const*)"]
    assert rows[1] == [0.025, 0.5, "void segment_sum_kernel(int)"]
    assert rep["table"]["other"] == [pytest.approx(0.035), 2]
    assert rep["kernels"]["composite_tiles_fwd"] == {"made": 2, "recorded": 2}
    assert rep["kernels"]["segment_sum_sorted"] == {"made": 1, "recorded": 1}
    assert rep["kernels"]["composite_tiles_bwd"] == {"made": None,
                                                     "recorded": 0}


def test_parse_only_reads_a_cpu_run(tmp_path, capsys):
    argv = ["--device", "cpu", "--res", "64", "--n", "300", "--capacity", "512",
            "--isect", "4096", "--steps", "2", "--trace-dir", str(tmp_path)]
    run = profile_step.main(argv)
    printed = capsys.readouterr().out
    again = profile_step.main(["--parse-only", "--trace-dir", str(tmp_path)])
    reparsed = capsys.readouterr().out
    assert again == run
    assert printed.split("trace ", 1)[1] == reparsed.split("trace ", 1)[1]
    assert run["steps"] == 2 and run["window_ms"] > 0
    assert run["device_events"] == 0 and "idle_share" not in run
    assert run["num_intersects"] > 0 and run["device"] == "cpu"
    with pytest.raises(SystemExit, match="no trace"):
        profile_step.main(["--parse-only", "--trace-dir", str(tmp_path / "x")])


# -- the microbenchmarks ------------------------------------------------------

def test_bench_render_cpu_frame():
    res = bench_render.main(["--device", "cpu", "--res", "64", "--n", "2000",
                             "--capacity", "2048", "--isect", "16384"])
    assert res["finite"] and res["num_intersects"] > 0
    assert res["launches_per_frame"]["composite_tiles_bwd"] == 0
    point = bench_point.bench_point(64, 2000, 2048, 16384, "cpu")
    out = bench_render.render_fn(point)()
    full = bench_render.render_fn(point, point.raster)()
    assert torch.equal(out["rgb"], full["rgb"])


def test_bench_refine_inputs_are_the_reference(monkeypatch):
    got = _capture(monkeypatch, "bench_refine", ["--caps", "4096"], jstrat,
                   "refine", jit=True)
    scene, adam, rs, step, key, cfg, num_train, size = got.args
    d = bench_refine.refine_draws(4096)
    n = d["pts"].shape[0]
    np.testing.assert_array_equal(np.asarray(scene.means)[:n], d["pts"])
    np.testing.assert_array_equal(np.asarray(rs.xys_grad_norm),
                                  d["xys_grad_norm"])
    np.testing.assert_array_equal(np.asarray(rs.max_2dsize), d["max_2dsize"])
    np.testing.assert_array_equal(np.asarray(rs.vis_counts), 1.0)
    ours = bench_refine.refine_inputs(4096, "cpu")
    np.testing.assert_array_equal(ours[0].means.detach().numpy(),
                                  np.asarray(scene.means))
    np.testing.assert_array_equal(ours[0].alive.numpy(), np.asarray(scene.alive))
    np.testing.assert_array_equal(ours[2].xys_grad_norm.numpy(),
                                  d["xys_grad_norm"])
    assert (int(step), num_train, size) == (bench_refine.STEP,
                                            bench_refine.NUM_TRAIN,
                                            bench_refine.IMG_SIZE)
    for f in ("warmup_length", "refine_every", "reset_alpha_every"):
        assert getattr(cfg, f) == getattr(bench_refine.CONFIG, f), f


def test_bench_refine_cpu_run_leaves_its_inputs():
    inputs = bench_refine.refine_inputs(4096, "cpu")
    before = inputs[0].means.detach().clone()
    first = bench_refine.run_refine(inputs)[3]
    second = bench_refine.run_refine(inputs)[3]
    assert torch.equal(inputs[0].means, before)
    assert {k: int(v) for k, v in first.items()} == \
        {k: int(v) for k, v in second.items()}
    res = bench_refine.main(["--device", "cpu", "--caps", "4096"])
    assert res["caps"][4096]["info"]["num_split"] > 0


def test_bench_sort_cases_equal_numpy():
    res = bench_sort.main(["--device", "cpu", "--logn", "10", "13"])
    assert len(res["cases"]) == 7
    assert all(e["equal"] for by_n in res["cases"].values()
               for e in by_n.values())
    a = bench_sort.case_inputs(64, np.random.default_rng(1))
    key = bench_sort.packed_key(a["tile"], a["depth"])
    order = np.lexsort((a["depth"], a["tile"]))
    np.testing.assert_array_equal(np.argsort(key, kind="stable"), order)


def test_bench_scatter_cases_equal_numpy():
    res = bench_scatter.main(["--device", "cpu", "--n", "5000", "--cap", "3000"])
    assert len(res["cases"]) == 16
    assert all(e["equal"] for e in res["cases"].values())
    assert bench_scatter.scatter_bytes(8, 3, 2) == 8 * 4 * 3 + 4 * 2 * 4


@pytest.mark.parametrize("command", ["geometry", "locality"])
def test_bench_gather_cases_equal_numpy(command):
    res = bench_gather.main([command, "--device", "cpu", "--n-out", "8192"])
    assert res["cases"] and all(
        e["equal"] for case in res["cases"].values()
        for e in ([case] if "equal" in case else case.values()))
    if command == "geometry":
        assert len(res["cases"]) == 12
        full = bench_gather.geometry_cases([], 1 << 20)
        assert full[0][:2] == (1 << 17, 128) and full[3][:2] == (1 << 20, 128)
    else:
        assert list(res["cases"]) == ["uniform", "window 2^13"]


def test_bench_gather_port_is_the_steps_gather():
    """``port`` gathers by the positions one step of the port computes (a
    permutation of the intersection buffer's slots), and every case equals
    numpy."""
    point = bench_point.bench_point(RES, N, CAP, ISECT, "cpu")
    positions = bench_gather.port_positions(point)
    assert positions.dtype == torch.int32 and positions.shape == (ISECT,)
    assert torch.equal(positions.sort().values,
                       torch.arange(ISECT, dtype=torch.int32))
    res = bench_gather.main(["port", "--device", "cpu", "--res", str(RES),
                             "--n", str(N), "--capacity", str(CAP), "--isect",
                             str(ISECT), "--n-out", "8192"])
    cases = res["cases"]
    assert len(cases) == 6 and all(c["equal"] for c in cases.values())
    assert cases["port positions int32"]["rows"] == ISECT
    assert cases["port positions int32"]["width"] == 10


def test_no_function_calls_a_global_it_shadows():
    """No function of the port assigns a name that the module imports or
    defines and also calls it or reads its attributes: Python makes every
    use of such a name in the function local, so the call reaches the
    local (``card = dev.type == "cuda"`` then ``card()`` calls a bool)."""
    bad = []
    for path in sorted((REPO / "gstk_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        module_names = set()
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                module_names |= {(a.asname or a.name).split(".")[0]
                                 for a in node.names}
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                module_names.add(node.name)
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            body = [n for st in fn.body for n in ast.walk(st)]
            stored = {n.id for n in body if isinstance(n, ast.Name)
                      and isinstance(n.ctx, ast.Store)}
            used = {n.func.id for n in body if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)}
            used |= {n.value.id for n in body if isinstance(n, ast.Attribute)
                     and isinstance(n.value, ast.Name)}
            for name in sorted(stored & module_names & used):
                bad.append(f"{path.relative_to(REPO)}:{fn.lineno} {fn.name}: "
                           f"{name}")
    assert not bad, bad


def test_tools_import_neither_jax_nor_the_reference(tmp_path):
    """The new tools import, and one runs, in a process where jax,
    gstk_tpu and the reference's ``tools`` cannot be imported."""
    names = ("bench_point", "profile_step", "bench_kernels", "bench_render",
             "bench_refine", "bench_sort", "bench_scatter", "bench_gather",
             "preflight", "quality_workflow")
    code = ("import sys\n"
            "for m in ('jax', 'gstk_tpu', 'tools'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            + "".join(f"importlib.import_module('gstk_torch.tools.{m}')\n"
                      for m in names)
            + "from gstk_torch.tools import bench_sort\n"
            "bench_sort.main(['--device', 'cpu', '--logn', '8'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'gstk_tpu', 'tools') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=tmp_path,
                   capture_output=True,
                   env={**os.environ, "PYTHONPATH": str(REPO)})


def test_kernel_device_ms_keeps_names_after_a_lost_session(monkeypatch):
    """A profiler session that records nothing is repeated; the session
    that records the launches still returns the kernels' names (a lost
    session once dropped them, and ``bench_gather`` failed on the card)."""
    import torch.profiler

    from gstk_torch import tools

    class Event:
        device_type = torch.autograd.DeviceType.CUDA
        key, self_device_time_total, count = "gather_kernel<float>", 30.0, 3

    sessions = []

    class Profile:
        def __init__(self, activities):
            sessions.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [] if len(sessions) < 3 else [Event()]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    out = tools.kernel_device_ms(lambda: None, "gather_kernel", 3, names=True)
    assert len(sessions) == 3
    assert out["names"] == {"gather_kernel<float>": 3}
    assert out["ms"] == 0.01 and out["profiler_launches"] == 3
    sessions.clear()
    monkeypatch.setattr(Profile, "key_averages", lambda self: [])
    with pytest.raises(RuntimeError, match="no launch of gather_kernel"):
        tools.kernel_device_ms(lambda: None, "gather_kernel", 3, names=True)
