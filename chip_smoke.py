"""Drive gstk_torch's render, train, eval and export paths and its three
methods on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero before the last
line:
  1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off
     for matmul and cuDNN in this process (the package's convolutions run
     in f32 either way; phase 13's subprocess keeps PyTorch's defaults);
  2. build: compile the CUDA kernels (``gstk_torch/csrc``) for sm_90a and
     print nvcc's register / shared-memory / spill report and the resident
     CTAs per SM of K1 and K2 (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
  3. scene: the render scene of ``bench.py`` (100k Gaussians, capacity
     104*1024, SH degree 3, 800x800, fx = fy = 1111) from a torch
     generator, written as a gstk_tpu-layout checkpoint;
  4. kernel K3 (segment broadcast) against its plain twin on the scene's
     tile-count cumsum, 1 and 3 columns, length 2**20, and edge cases (a
     long tail past the last boundary, a run of equal boundaries wider than
     a CTA's run): exact equality;
  5. kernel K1 (tile compositing) against its plain twin on the scene's
     intersections at ch = 4: rtol 1e-3 / atol 1e-4;
  6. render path: ``Renderer(checkpoint, device="cuda")`` answers 8 requests
     (the bench camera and 7 pose offsets) with the launch counters reset
     just before; request 0 is compared with the same render through the
     plain twins on the card;
  7. K1 and K3 timings at the render shapes (K1 given the packed record, as
     the render path gives it), the device time of ``pack_records`` and of
     a fill of K3's output (a floor for its bytes);
     kernel times are torch.profiler's mean over the launches it recorded,
     printed with that count and the total over the calls made;
  8. train scene: ``bench.py``'s training point (the phase-3 scene,
     ``isect_capacity`` 3<<18, black background, default optimizer, a
     uniform gt image from the seed-0 generator), no truncation; the tile
     range lengths (mean, p99, max);
  9. kernels K2 (compositing backward) and K4 (segment sum) against their
     plain twins on the scene's intersections and the cotangents of the
     step's loss (K2 rtol 5e-3 / atol 1e-4 max|g| per column, and again with
     a random final_t cotangent; K4 rtol 1e-5 / atol 1e-6 of each segment's
     sum of magnitudes); K2 -> gather -> K4 twice must be bit-identical;
     the segment lengths K4 sums (mean, p99, max, empty, longer than a
     thread sums alone) and the device time of the gather by expansion
     position and of an attribute-major copy of its result;
     the (tile, warp, entry) triples with a kept pixel, from the plain
     walk, for warps of 32 pixels (one pixel a thread) and
     of 64 (two a thread, as K2's), and the time their warp shuffles
     take at 5 (6 + ch) and at 16 shuffles each;
  10. train path: one step through the kernels, with the launch counters
     reset just before, against the same step with ``backend="plain"``
     from the same state (loss, gradients, updates, statistics, with the
     CPU step test's tolerances); then 2 warm-up and 10 timed steps (host
     clock, synchronized), one traced step (its cat launches listed), and
     K2 / K4 / ``pack_records`` timings, with one ``torch.sum`` over the
     values K4 covers (a floor for its bytes); ``refine`` on this state
     (capacity 104*1024, 100k alive) at a densifying step, synchronized;
  11. trainer path: the port's synthetic-dataset generator writes 24 views
     at 800x800 of its 500-point object on the card, the dataset's seed
     cloud is rewritten with 100k points drawn around the object's, and
     ``gstk_torch.scripts.train.main`` trains gaussian-splatting on it for
     400 steps in this process (every step at 800x800, SH degree 3 from
     step 300, refinement densifying at steps 200-400, one eval view every
     100 steps), with the launch counters reset just before; K1-K4 must
     each launch, the losses stay finite, ``num_alive`` change, the final
     eval PSNR beat the first ``eval_image`` PSNR (step 99), the final
     checkpoint render an eval view through ``Renderer(..., device="cuda")``
     as the trainer renders it, one trainer step from the trained state
     and one eval render match the same through the plain twins (phase
     10's and phase 6's tolerances), ``refine`` on the card equal
     ``refine`` on the CPU from the same state and noise, and Pillow,
     OpenCV and PyYAML stay unimported; prints the trainer's per-step wall
     time (its ``ITER_TRAIN_TIME``, and 20 more steps synchronized),
     ``refine`` at the trained capacity, ``eval_all`` per view, each
     capacity growth up to the 2^21 ceiling (forced after the run) and
     ``refine`` at that ceiling, synchronized; then the d = 4 bucket of the
     train split (the default coarse-to-fine start) is built with the
     device peak measured, which must stay under the bytes the trainer's
     budget check counts, and must equal the per-frame path bit for bit;
     and ``read_png`` reads an 800x800 Paeth-filtered PNG built here with
     numpy and zlib, bit-exact and timed;
  12. probes: with the probes' launch counters reset just before, the
     entry points ``gstk_torch.tools.ablate_fwd.main`` (P1: K1's ablation
     clones at the tool's two shapes, T=2048/C=1 and T=128/C=16) and
     ``gstk_torch.tools.bench_dynrow.main`` (P2 and P3: row scatters at
     n = 2^20 rows against their plain twins and ``index_copy_`` bit for
     bit, beside the gather baseline) each launch; then every P1 clone
     against its plain twin at both shapes (rtol 1e-3 / atol 1e-4,
     ``dmaonly`` rtol 1e-6), ``full`` and ``marg_none`` against K1 and
     ``noexit`` against ``full`` bit for bit, and ``full``, ``noexit`` and
     ``dmaonly`` timed on phase 7's render inputs beside K1;
  13. back end, on phase 11's run directory (its step-400 checkpoint),
     through the CLIs' ``main``: gs-eval (``--skip-lpips``) launches K1 and
     K3 once a view and equals the trainer's final eval (PSNR rtol 1e-4,
     SSIM atol 1e-4), as do ``--force-host-loop`` and a fresh ``python -m
     gstk_torch.scripts.eval`` process under PyTorch's default TF32 flags;
     its device loop timed and one view traced; SSIM of one view with
     cuDNN's TF32 against f32; gs-eval with random LPIPS weights written as
     an npz gives a finite LPIPS, and LPIPS on a 128x128 crop of one pair
     on the card equals the CPU's (rtol 1e-4); gs-render ``pose`` writes
     21 rgb and depth PNGs, each equal to the Renderer's output quantized
     alike, and ``poses.json``; gs-render ``trajectory`` renders 8 poses at
     1920x1080 in four bands, K1 and K3 four times a frame, each band's
     tile ranges ordered and ending at its intersection count, one frame
     against the plain twins (phase 6's tolerances, 0.1% of values
     outside), frames timed and one traced; gs-export ``gaussian-splat``
     byte for byte ``--device cpu``'s, ``camera-poses``, ``point-cloud``,
     ``offline-tsdf`` at its defaults (200^3 voxels) with marching
     tetrahedra, and with Poisson, ``--clean`` and ``--mask-method
     threshold``, each mesh non-empty; the fused volume on the card against
     the CPU on the same frames (tsdf and colors within atol 1e-5 on all
     but 0.1% of voxels, weights equal outside them), integration, Poisson
     and marching tetrahedra timed; Pillow, OpenCV, PyYAML, torchvision and
     transformers stay unimported;
  14. methods, on phase 11's dataset (800x800, 21 train views, the 100k
     seed cloud in 2^19 lanes): (b) ``gstk_torch.scripts.train co-gs`` for
     300 steps with sensor depth from step 0 and SO3xR3 camera optimisation
     (``ITER_TRAIN_TIME``, final eval PSNR, the depth-L1 term at its first
     and last log, the camera adjustments finite and moved); (a) from its
     trained state (step 300: every gate open, scales anisotropic), one
     co-gs step (sensor depth L1, the sparse term, the planar term on 32x32
     patches, the camera group over the 21 views) through the kernels,
     with the launch counters reset just before (K1-K4 once each), against
     the same step with ``backend="plain"`` and a generator of the same
     seed (phase 10's tolerances, the camera group's moments and update
     too); K2's depth column is nonzero, the camera gradient finite and
     nonzero, no moment non-finite; the step timed and traced beside the
     vanilla method's step from the same state, and ``torch.linalg.eigh``
     on (16, 3, 3) timed; (c) ``surface-gs`` for 300 steps through d = 4,
     2, 1 (a bucket every 100 steps), refining from step 100: every alive
     mean equals the seed cloud's bit for bit, no split or dup, the step
     time of each bucket; (b) and (c) with the counters reset just before
     each and K1-K4 launched; the phase's wall time;
then one ``kernels`` JSON line (K1-K4: launches per train step, times,
bounds, and phase 14's launches under ``launches_methods``; P1-P3:
launches in phase 12's run of the probes; phase 11's numbers under
``trainer``, phase 12's under ``probes``, phase 13's, K1 and K3 launches a
view and a frame included, under ``backend``, phase 14's under
``methods``), the card's name and power limit, and the last line ``{"ok":
true, "device": {...}}``.
Kernel times are torch.profiler's device time; a kernel it records no
launch of after three sessions fails the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from gstk_torch import _build
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import init_scene, scene_from_numpy, scene_to_numpy
from gstk_torch.models.vanilla import (
    VanillaConfig,
    composite_gt_with_background,
    rgb_loss,
    splat_inputs,
)
from gstk_torch.ops.binning import bin_gaussians, expansion_positions
from gstk_torch.ops.projection import tight_extents, tile_bbox
from gstk_torch.ops.raster_cuda import (
    composite_tiles_bwd,
    composite_tiles_bwd_plain,
    composite_tiles_fwd,
    composite_tiles_fwd_plain,
    KERNEL_CHANNELS,
    _walk,
    pack_records,
    resident_ctas,
)
from gstk_torch.ops.rasterize import RasterizeConfig, _tiles_to_image
from gstk_torch.ops.segment_kernel import (
    segment_broadcast,
    segment_broadcast_plain,
    segment_sum_sorted,
    segment_sum_sorted_plain,
)
from gstk_torch.configs.methods import method_configs
from gstk_torch.configs.serialize import load_config
from gstk_torch.core.camera_opt import CameraOptConfig
from gstk_torch.data.datamanager import FullImageDatamanager
from gstk_torch.data.synthetic import ISECT_CAPACITY, generate_synthetic_dataset
from gstk_torch.exporter.poisson import poisson_indicator
from gstk_torch.exporter.tsdf import integrate_frames, make_volume, marching_tetrahedra
from gstk_torch.render.renderer import Renderer
from gstk_torch.scripts import eval as eval_cli
from gstk_torch.scripts import export as export_cli
from gstk_torch.scripts import render as render_cli
from gstk_torch.scripts.train import main as train_main
from gstk_torch.tools import ablate_fwd, bench_dynrow, kernel_device_ms
from gstk_torch.train.checkpoint import (
    save_scene,
    train_state_from_numpy,
    train_state_to_numpy,
)
from gstk_torch.train.optim import OptimizerConfig
from gstk_torch.train.step import init_train_state, make_train_step
from gstk_torch.train.strategy import refine
from gstk_torch.train import trainer as trainer_mod
from gstk_torch.train.trainer import Trainer, area_downscale, train_cache_bytes
from gstk_torch.utils.colors import EVAL_BACKGROUND
from gstk_torch.utils import losses
from gstk_torch.utils.io import read_ply, read_png, read_ply_points, write_ply
from gstk_torch.utils.lpips import lpips, random_lpips_params
from gstk_torch.utils.profiler import PROFILER

SEED = 0
N_POINTS, CAPACITY, SH_DEGREE = 100_000, 104 * 1024, 3
H = W = 800
FOCAL = 1111.0
REQUESTS = 8
TRAIN_ISECT = 3 << 18  # bench.py's training isect_capacity
TRAIN_STEPS = 10  # timed, after 2 warm-ups
K4_SHORT = 32  # the longest segment a thread of K4 sums alone (kShort)
DEVICE = "cuda"
PARITY = dict(rtol=1e-3, atol=1e-4)  # gstk_tpu's image parity tolerances
RTOL_GRAD = 5e-3  # gstk_tpu's gradient parity tolerance
MAX_OUTSIDE = 0.005  # share of a group allowed outside it (cutoff flips)
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
K1_FLOP_PER_PAIR = 21  # ~20 FLOP + 1 exp per (pixel, entry) pair evaluated
# K2 (csrc/composite_bwd.cu): the recompute per pair evaluated, and the
# gradient per pair kept, at ch channels. The sum over pixels counts the
# 6 + ch adds a pair needs, not the butterfly's 16 padded adds and selects
# a lane, nor any shuffle: those are the kernel's cost, not the function's.
K2_FLOP_PER_PAIR = 15
K2_FLOP_PER_KEPT = lambda ch: 37 + 4 * ch
# phase 11: the synthetic object's points, few enough that no 800x800 view
# of the generator's render exceeds its ISECT_CAPACITY (2^17) intersections
# (it raises if one does; the count grows with the points)
SYN_POINTS, SYN_VIEWS = 500, 24
# the trainer's seed cloud: phase 10's count, each point one of the
# object's, picked at random, jittered by N(0, SEED_JITTER) on each axis
SEED_POINTS, SEED_JITTER = N_POINTS, 0.05
TRAIN_ITERS = 400
REFINE_TIMES = 5  # synchronized refine calls timed, median reported
REFINE_STEP = 1000  # phase 10's refine: past warmup, densifying
# phase 13: gs-eval against the trainer's eval (PSNR rtol, SSIM atol)
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-4
LPIPS_CROP = 128  # LPIPS on the card against the CPU on this square of a pair
# gs-render trajectory: 8 poses at the camera path's default size, which
# the Renderer splits into ceil(1920 * 1080 / 640,000) = 4 bands
TRAJ_POSES, TRAJ_W, TRAJ_H, TRAJ_BANDS = 8, 1920, 1080, 4
# gs-export offline-tsdf's defaults: a 2 m cube of 1 cm voxels (200^3)
TSDF_SIZE, TSDF_VOXEL, TSDF_TRUNC, POISSON_ITERS = 2.0, 0.01, 0.04, 200
TSDF_ATOL, TSDF_OUTSIDE = 1e-5, 1e-3  # voxels where a round of u or v flips
# phase 14: the runs take 300 steps (at the co-gs run's last, the sparse
# gate, step % 100 == 0, and the depth and planar gates, step > 0, are all
# open), surface-gs's buckets 100 each
PLANAR_PATCH, METHOD_ITERS, SURFACE_SCHEDULE = 32, 300, 100
K2_DEPTH_COLUMN = 6 + 3  # K2's rows: [x, y, a, b, c, opacity, r, g, b, depth]
REPO = Path(__file__).resolve().parent


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_scene(device):
    """bench.py's scene: uniform points in front of an identity camera,
    kNN scales replaced by tight log-scales, opacities in [0.3, 0.9]."""
    g = torch.Generator().manual_seed(SEED)

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).numpy()

    pts = u(-3.0, 3.0, N_POINTS, 3)
    pts[:, 2] = u(-9.0, -2.0, N_POINTS)
    rgb = u(0.0, 255.0, N_POINTS, 3)
    arrays = scene_to_numpy(init_scene(
        g, CAPACITY, (pts, rgb), sh_degree=SH_DEGREE, device="cpu"
    ))
    arrays["scales"][:N_POINTS] = u(-4.5, -2.5, N_POINTS, 3)
    op = u(0.3, 0.9, N_POINTS)
    arrays["opacities"][:N_POINTS, 0] = np.log(op / (1.0 - op))
    return scene_from_numpy(arrays, device)


def pose(i: int) -> np.ndarray:
    """Request i's c2w: the bench camera (i = 0) and small offsets of it."""
    c2w = np.eye(4, dtype=np.float32)[:3]
    if i:
        a = 0.02 * np.array([math.sin(i), math.cos(2 * i), math.sin(3 * i)])
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        u, _, vt = np.linalg.svd(np.eye(3) + K)
        c2w[:, :3] = u @ vt
        c2w[:, 3] = 0.1 * np.array([math.cos(i), math.sin(2 * i), 0.5 * math.sin(i)])
    return c2w


def assert_close(name, got, want, rtol, atol, max_outside=0.0):
    """|got - want| <= atol + rtol |want| for all but a ``max_outside``
    share of the values; ``atol`` may be a tensor that broadcasts (a
    tolerance per column or row). Returns the number outside."""
    ok = (got - want).abs() <= atol + rtol * want.abs()
    bad = int((~ok).sum())
    if bad > max_outside * ok.numel():
        raise AssertionError(
            f"{name}: {bad} of {ok.numel()} values outside rtol {rtol}, max "
            f"abs err {float((got - want).abs().max())}"
        )
    return bad


def event_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events around ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="gstk_torch_smoke_") as ckpt_dir:
        return run(ckpt_dir)


def run(ckpt_dir: str) -> int:
    """The phases; the checkpoint goes to ``ckpt_dir``."""
    dev = torch.device(DEVICE)

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    phase("2 build")
    build = _build.build()
    print(f"build {build.seconds:.2f} s (compiled now: {build.built}) -> {build.library}")
    for line in build.ptxas_log.splitlines():
        if line.startswith("==") or any(k in line for k in ("registers", "spill", "Compiling entry")):
            print("  " + line.strip())
    resident = {}
    for name, kernel in (("composite_tiles_fwd", "fwd"), ("composite_tiles_bwd", "bwd")):
        resident[name] = {ch: resident_ctas(kernel, ch) for ch in KERNEL_CHANNELS}
        print(f"{name}: resident CTAs per SM by ch {resident[name]}")

    phase("3 scene")
    t0 = time.perf_counter()
    scene = bench_scene(dev)
    path = save_scene(ckpt_dir, scene, step=0, extras={
        "isect_capacity": 3 << 18, "bands": 1, "sh_degree": SH_DEGREE,
    })
    camera = Camera.create(FOCAL, FOCAL, W / 2, H / 2, pose(0), device=dev)
    raster = RasterizeConfig(isect_capacity=1 << 20)
    with torch.no_grad():
        inputs = splat_inputs(scene, camera, H, W, sh_degree=SH_DEGREE,
                              config=VanillaConfig())
        # rasterize's footprints and tile counts at one band
        ext = tight_extents(inputs["conics"], inputs["opacities"],
                            inputs["radii"].float())
        tiles = ((W + 15) // 16, (H + 15) // 16)
        tmin, tmax = tile_bbox(inputs["xys"], ext, tiles, 16)
        area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
        counts = torch.where((ext[:, 0] > 0) & (ext[:, 1] > 0), area, 0).int()
        isect = bin_gaussians(inputs["xys"], inputs["depths"], ext, counts,
                              tiles, 16, raster.isect_capacity)
    n_isect = int(isect.num_intersects)
    print(f"scene {N_POINTS} Gaussians (capacity {CAPACITY}), {W}x{H}, "
          f"{n_isect} intersections of capacity {raster.isect_capacity}, "
          f"{time.perf_counter() - t0:.1f} s; checkpoint {path}")
    assert 0 < n_isect <= raster.isect_capacity, "truncated or empty"

    phase("4 K3 segment_broadcast vs plain twin")
    cum = torch.cumsum(counts.long(), 0).int()
    g = torch.Generator(device=dev).manual_seed(SEED)
    rand_i32 = lambda n: torch.randint(-2**31, 2**31, (n,), generator=g,
                                       device=dev, dtype=torch.int64).int()
    ones = torch.ones(CAPACITY, dtype=torch.int32, device=dev)
    depth_bits = inputs["depths"].contiguous().view(torch.int32)
    zeroed = torch.where(torch.rand(CAPACITY, generator=g, device=dev) < 0.5, 0, counts)
    k3_cases = {
        "main path (1 column)": (cum, [ones]),
        "3 columns": (cum, [ones, torch.diff(depth_bits, append=depth_bits[:1]),
                            rand_i32(CAPACITY)]),
        "past length": (cum * 3, [ones, rand_i32(CAPACITY)]),
        "zero counts": (torch.cumsum(zeroed.long(), 0).int(), [ones, rand_i32(CAPACITY)]),
        # the last boundary at about 0.35 of length
        "long tail": (cum // 2, [ones, rand_i32(CAPACITY)]),
        # 3000 boundaries at slot 5001: runs of 64 that own no slot
        "wide window": (torch.sort(torch.cat([
            cum[:-3000], torch.full((3000,), 5001, dtype=cum.dtype, device=dev),
        ])).values, [ones, rand_i32(CAPACITY)]),
    }
    for name, (b, ds) in k3_cases.items():
        got = segment_broadcast(b, ds, raster.isect_capacity)
        want = segment_broadcast_plain(b, ds, raster.isect_capacity)
        torch.cuda.synchronize()
        for c, (x, y) in enumerate(zip(got, want)):
            if not torch.equal(x, y):
                raise AssertionError(f"K3 {name} column {c}: "
                                     f"{int((x != y).sum())} slots differ")
        print(f"K3 {name}: {len(ds)} x {raster.isect_capacity} slots equal, "
              f"boundaries up to {int(b.max())}, "
              f"{max(raster.isect_capacity - int(b.max()), 0)} slots past the last")

    phase("5 K1 composite_tiles_fwd vs plain twin (ch = 4)")
    k1_args = (inputs["xys"], inputs["conics"], inputs["opacities"],
               inputs["colors"], isect.gaussian_ids, isect.tile_bins, tiles)
    acc, final_t = composite_tiles_fwd(*k1_args)
    acc_p, final_t_p, visited = composite_tiles_fwd_plain(*k1_args)
    torch.cuda.synchronize()
    assert_close("K1 acc", acc, acc_p, **PARITY)
    assert_close("K1 final_t", final_t, final_t_p, **PARITY)
    k1_err = max(float((acc - acc_p).abs().max()), float((final_t - final_t_p).abs().max()))
    pairs = int(visited.sum())
    print(f"K1 max abs err {k1_err:.3g} (acc {tuple(acc.shape)}, final_t "
          f"{tuple(final_t.shape)}); {pairs} (pixel, entry) pairs evaluated")

    phase("6 render path: Renderer, 8 requests")
    renderer = Renderer(ckpt_dir, device=dev)
    assert renderer.raster_config.isect_capacity == raster.isect_capacity
    args = lambda i: (pose(i), FOCAL, FOCAL, W / 2, H / 2, H, W)
    for _ in range(2):  # warm-ups
        renderer.get_output_from_pose(*args(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_tiles_fwd.launches = 0
    segment_broadcast.launches = 0
    outs, ms = [], []
    for i in range(REQUESTS):
        t0 = time.perf_counter()
        out = renderer.get_output_from_pose(*args(i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {"composite_tiles_fwd": composite_tiles_fwd.launches,
                "segment_broadcast": segment_broadcast.launches}
    peak = torch.cuda.max_memory_allocated()
    print(f"request ms: median {statistics.median(ms):.3f}, min {min(ms):.3f} "
          f"(host clock, synchronized; {REQUESTS} requests after 2 warm-ups)")
    print(f"num_intersects {[o['num_intersects'] for o in outs]} of capacity "
          f"{raster.isect_capacity}; peak memory {peak / 2**20:.1f} MiB; "
          f"launches {launches}")
    for name, n in launches.items():
        assert n >= REQUESTS, f"{name} launched {n} times for {REQUESTS} requests"
    for i, o in enumerate(outs):
        assert o["num_intersects"] <= raster.isect_capacity, f"request {i} truncated"
        assert o["rgb"].shape == (H, W, 3) and o["depth"].shape == (H, W)
        for k in ("rgb", "depth", "accumulation"):
            assert np.isfinite(o[k]).all(), f"request {i} {k} not finite"
        assert 0.05 < o["accumulation"].mean() < 1.0, "request renders nothing"
    assert outs[0]["num_intersects"] == n_isect
    plain = Renderer(ckpt_dir, device=dev, raster_config=RasterizeConfig(
        isect_capacity=raster.isect_capacity, bands=0, backend="plain"))
    ref = plain.get_output_from_pose(*args(0))
    main_err = {}
    for k in ("rgb", "depth", "accumulation"):
        assert_close(f"request 0 {k}", torch.from_numpy(outs[0][k]),
                     torch.from_numpy(ref[k]), **PARITY)
        main_err[k] = float(np.abs(outs[0][k] - ref[k]).max())
    print(f"request 0 vs plain twins on the card: max abs err {main_err}")
    trace("request", lambda: renderer.get_output_from_pose(*args(0)))

    phase("7 K1 and K3 timings (render shapes)")
    iters = 20
    length = raster.isect_capacity
    j = torch.arange(length, dtype=torch.int32, device=dev)
    k3_in = (torch.clamp(cum, max=length), [ones], length)
    k3 = {
        **kernel_device_ms(lambda: segment_broadcast(*k3_in),
                           "segment_broadcast_kernel", iters),
        "wrapper_ms": event_ms(lambda: segment_broadcast(*k3_in), iters),
        "plain_ms": event_ms(lambda: segment_broadcast_plain(*k3_in), iters),
        # with d = 1 the function is #{i: b[i] <= j}: one searchsorted
        "library_ms": event_ms(lambda: torch.searchsorted(k3_in[0], j, right=True), iters),
    }
    # a yardstick for K3's bytes: a fill of its 4-B-a-slot output
    fill_out = torch.empty(length, dtype=torch.int32, device=dev)
    floors = {"k3_fill": kernel_device_ms(lambda: fill_out.fill_(7), None, iters)}
    k3_bytes = 4 * CAPACITY * 2 + 4 * length  # b and d read, one column written
    k3_ops = length * math.ceil(math.log2(CAPACITY)) * 4  # search steps
    k1_rec = pack_records(*k1_args[:4])
    k1 = {
        **kernel_device_ms(lambda: composite_tiles_fwd(*k1_args, records=k1_rec),
                           "composite_fwd_kernel", iters),
        "wrapper_ms": event_ms(lambda: composite_tiles_fwd(*k1_args, records=k1_rec),
                               iters),
        "plain_ms": event_ms(lambda: composite_tiles_fwd_plain(*k1_args), 3),
        "library_ms": None,  # no single PyTorch call composites tiles
    }
    ch = inputs["colors"].shape[1]
    num_tiles = tiles[0] * tiles[1]
    k1_bytes = (n_isect * (4 + 4 * (6 + ch)) + num_tiles * 8
                + num_tiles * 256 * (ch + 1) * 4)
    k1_ops = pairs * K1_FLOP_PER_PAIR
    # the record K1 and K2 read, built once per band outside both kernels
    pack = {"render": kernel_device_ms(lambda: pack_records(*k1_args[:4]),
                                       None, iters)}
    print(f"K3 {k3}\nK1 {k1}\npack_records {pack['render']}")
    del renderer, plain, outs

    phase("8 train scene")
    model_cfg = VanillaConfig(sh_degree=SH_DEGREE, background_color="black")
    train_raster = RasterizeConfig(isect_capacity=TRAIN_ISECT)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    gt = torch.rand((H, W, 3), generator=gen, device=dev)
    scene = bench_scene(dev)
    with torch.no_grad():
        t_in = splat_inputs(scene, camera, H, W, sh_degree=SH_DEGREE,
                            config=model_cfg)
        ext = tight_extents(t_in["conics"], t_in["opacities"],
                            t_in["radii"].float())
        tmin, tmax = tile_bbox(t_in["xys"], ext, tiles, 16)
        area = (tmax[:, 0] - tmin[:, 0]) * (tmax[:, 1] - tmin[:, 1])
        t_counts = torch.where((ext[:, 0] > 0) & (ext[:, 1] > 0), area, 0).int()
        t_isect = bin_gaussians(t_in["xys"], t_in["depths"], ext, t_counts,
                                tiles, 16, TRAIN_ISECT)
    t_n_isect = int(t_isect.num_intersects)
    print(f"train scene: {t_n_isect} intersections of capacity {TRAIN_ISECT}")
    assert 0 < t_n_isect <= TRAIN_ISECT, "training intersections truncated"
    lengths = (t_isect.tile_bins[:, 1] - t_isect.tile_bins[:, 0]).double()
    tile_lengths = {"mean": float(lengths.mean()),
                    "p99": float(torch.quantile(lengths, 0.99)),
                    "max": float(lengths.max())}
    print(f"tile range lengths over {lengths.numel()} tiles: mean "
          f"{tile_lengths['mean']:.3f}, p99 {tile_lengths['p99']:.3f}, max "
          f"{tile_lengths['max']:.0f} (max / mean "
          f"{tile_lengths['max'] / tile_lengths['mean']:.3f})")

    phase("9 K2 composite_tiles_bwd and K4 segment_sum_sorted vs plain twins")
    fwd_args = (t_in["xys"], t_in["conics"], t_in["opacities"], t_in["colors"],
                t_isect.gaussian_ids, t_isect.tile_bins, tiles)
    acc, final_t = composite_tiles_fwd(*fwd_args)
    _, _, t_visited = composite_tiles_fwd_plain(*fwd_args)
    g_acc, g_final_t = step_cotangents(acc, final_t, tiles, gt, scene, model_cfg)
    bwd_args = fwd_args[:6] + (acc, final_t, g_acc, g_final_t, tiles)
    g_t_random = torch.randn(final_t.shape, generator=gen, device=dev)
    k2_err = 0.0
    # With a random final_t cotangent, an entry at T ~ 1e-4 carries a large
    # gradient, and where the kernel's sequential T and the twin's cumprod
    # round to opposite sides of the 1e-4 stop, one of them has that entry
    # and the other not: a few in a million may fall outside.
    for label, args, max_outside in (
        ("the step's cotangents", bwd_args, 0.0),
        ("a random final_t cotangent", bwd_args[:9] + (g_t_random, tiles), 1e-5),
    ):
        gout = composite_tiles_bwd(*args)
        gout_p, t_kept = composite_tiles_bwd_plain(*args)
        torch.cuda.synchronize()
        scale = gout_p.abs().amax(0, keepdim=True)
        bad = assert_close(f"K2 gout ({label})", gout, gout_p, rtol=RTOL_GRAD,
                           atol=1e-4 * scale, max_outside=max_outside)
        err = float((gout - gout_p).abs().max())
        print(f"K2 with {label}: max abs err {err:.3g}, {bad} values outside "
              f"the tolerance, column max {[round(float(x), 6) for x in scale[0]]}")
        if max_outside == 0.0:
            k2_err = err
    gout = composite_tiles_bwd(*bwd_args)
    positions = expansion_positions(t_isect)
    hi = torch.clamp(torch.cumsum(t_counts.long(), 0), max=TRAIN_ISECT)
    g_et = gout.index_select(0, positions).t()  # entry-major, as K4 reads it
    sums = segment_sum_sorted(g_et, hi)
    sums_p = segment_sum_sorted_plain(g_et, hi)
    torch.cuda.synchronize()
    # f32 summation error grows with the segment's sum of magnitudes
    mag = segment_sum_sorted_plain(g_et.abs(), hi)
    assert_close("K4 sums", sums, sums_p, rtol=1e-5, atol=1e-6 * mag)
    k4_err = float((sums - sums_p).abs().max())

    def backward_once():
        g = composite_tiles_bwd(*bwd_args)
        return segment_sum_sorted(g.index_select(0, positions).t(), hi)

    first, second = backward_once(), backward_once()
    torch.cuda.synchronize()
    assert torch.equal(first, second), "K2 -> gather -> K4 is not deterministic"
    t_pairs, t_kept_pairs = int(t_visited.sum()), int(t_kept.sum())
    print(f"K2 max abs err {k2_err:.3g} (gout {tuple(gout.shape)}); K4 max abs "
          f"err {k4_err:.3g} (sums {tuple(sums.shape)}); backward bit-identical "
          f"over two runs; {t_pairs} (pixel, entry) pairs evaluated, "
          f"{t_kept_pairs} kept")
    seg_len = torch.diff(hi, prepend=hi.new_zeros(1))
    k4_segments = {"mean": float(seg_len.double().mean()),
                   "p99": float(torch.quantile(seg_len.double(), 0.99)),
                   "max": int(seg_len.max()), "empty": int((seg_len == 0).sum()),
                   f"longer_than_{K4_SHORT}": int((seg_len > K4_SHORT).sum()),
                   "segments": int(seg_len.numel())}
    print(f"K4 segment lengths: {k4_segments}")
    gathered = gout.index_select(0, positions)
    k4_glue = {
        # the gather the backward runs before K4
        "gather": kernel_device_ms(lambda: gout.index_select(0, positions), None, iters),
        # the attribute-major copy K4 no longer needs
        "attribute_major_copy": kernel_device_ms(lambda: gathered.t().contiguous(),
                                                 None, iters),
    }
    print(f"K4 glue: {k4_glue}")
    warp_entries = kept_warp_entries(fwd_args)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    shuffle_ms = lambda n, s: n * s / (sms * mhz * 1e6) * 1e3
    for px, n in warp_entries.items():
        print(f"{n} (tile, warp, entry) triples with a kept pixel for warps of "
              f"{px} pixels; at one warp shuffle per SM and clock ({sms} SMs, "
              f"{mhz:.0f} MHz max SM clock) their shuffles take "
              f"{shuffle_ms(n, 5 * (6 + ch)):.4f} ms at {5 * (6 + ch)} each, "
              f"{shuffle_ms(n, 16):.4f} ms at 16 each")

    phase("10 train path: one step through the kernels vs backend='plain'")
    step_fn = make_train_step(model_cfg, train_raster, OptimizerConfig(), H, W,
                              sh_degree=SH_DEGREE)
    plain_fn = make_train_step(
        model_cfg, RasterizeConfig(isect_capacity=TRAIN_ISECT, backend="plain"),
        OptimizerConfig(), H, W, sh_degree=SH_DEGREE,
    )
    state = init_train_state(bench_scene(dev))
    state_p = init_train_state(bench_scene(dev))
    before = train_state_to_numpy(state)
    torch.cuda.synchronize()
    counters = (composite_tiles_fwd, composite_tiles_bwd, segment_broadcast,
                segment_sum_sorted)
    for f in counters:
        f.launches = 0
    state, metrics = step_fn(state, camera, gt)
    torch.cuda.synchronize()
    step_launches = {f.__name__: f.launches for f in counters}
    state_p, metrics_p = plain_fn(state_p, camera, gt)
    torch.cuda.synchronize()
    print(f"launches in one train step: {step_launches}")
    for name, n in step_launches.items():
        assert n >= 1, f"{name} not launched by the train step"
    compare_steps(metrics, metrics_p, before, train_state_to_numpy(state),
                  train_state_to_numpy(state_p), OptimizerConfig())

    ms_steps = []
    for i in range(2 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, camera, gt)
        torch.cuda.synchronize()
        ms_steps.append((time.perf_counter() - t0) * 1e3)
    ms_steps = ms_steps[2:]
    assert all(math.isfinite(float(metrics[k])) for k in ("loss", "psnr"))
    print(f"train step ms: median {statistics.median(ms_steps):.3f}, min "
          f"{min(ms_steps):.3f} (host clock, synchronized; {TRAIN_STEPS} steps "
          f"after 2 warm-ups); loss {float(metrics['loss']):.5f}, psnr "
          f"{float(metrics['psnr']):.3f}, num_intersects "
          f"{int(metrics['num_intersects'])}")
    # the cat of pack_records is one of the step's CatArrayBatchedCopy launches
    trace("train step", lambda: step_fn(state, camera, gt),
          show=("CatArrayBatchedCopy",))

    k2_rec = pack_records(*fwd_args[:4])
    k2 = {
        **kernel_device_ms(lambda: composite_tiles_bwd(*bwd_args, records=k2_rec),
                           "composite_bwd_kernel", iters),
        "wrapper_ms": event_ms(lambda: composite_tiles_bwd(*bwd_args, records=k2_rec),
                               iters),
        "plain_ms": event_ms(lambda: composite_tiles_bwd_plain(*bwd_args), 3),
        "library_ms": None,  # no single PyTorch call composites backward
    }
    rows = g_et.shape[0]
    n_seg = hi.shape[0]
    covered = int(hi[-1])
    lib_vals = g_et.t()[:covered]  # entry-major, as K4 reads it
    lib_vals_t = g_et[:, :covered].contiguous()  # attribute-major
    lib_lengths_t = seg_len[None].expand(rows, n_seg).contiguous()
    k4 = {
        **kernel_device_ms(lambda: segment_sum_sorted(g_et, hi),
                           "segment_sum_kernel", iters),
        "wrapper_ms": event_ms(lambda: segment_sum_sorted(g_et, hi), iters),
        "plain_ms": event_ms(lambda: segment_sum_sorted_plain(g_et, hi), iters),
        "library_ms": event_ms(lambda: torch.segment_reduce(
            lib_vals, "sum", lengths=seg_len, axis=0), iters),
        "library_axis1_ms": event_ms(lambda: torch.segment_reduce(
            lib_vals_t, "sum", lengths=lib_lengths_t, axis=1), iters),
    }
    # a yardstick for K4's bytes: one read of the values it covers
    floors["k4_read"] = kernel_device_ms(lambda: torch.sum(lib_vals), None, iters)
    lib = torch.segment_reduce(lib_vals, "sum", lengths=seg_len, axis=0)
    assert_close("segment_reduce vs K4", lib.t(), sums, rtol=1e-5, atol=1e-6 * mag)
    pack["train"] = kernel_device_ms(lambda: pack_records(*fwd_args[:4]), None, iters)
    print(f"K2 {k2}\nK4 {k4}\npack_records {pack['train']}")
    _, bench_info, bench_refine_ms = refine_runs(
        train_state_to_numpy(state), model_cfg, 1, W, DEVICE, REFINE_STEP,
        REFINE_TIMES)
    print(f"refine at capacity {CAPACITY} ({N_POINTS} alive), step "
          f"{REFINE_STEP}: {[round(x, 3) for x in bench_refine_ms]} ms "
          f"(synchronized); info {bench_info}")
    k2_bytes = (TRAIN_ISECT * (6 + ch) * 4 + t_n_isect * (4 + 4 * (6 + ch))
                + num_tiles * 256 * (2 * ch + 2) * 4 + num_tiles * 8)
    k2_ops = t_pairs * K2_FLOP_PER_PAIR + t_kept_pairs * K2_FLOP_PER_KEPT(ch)
    k4_bytes = rows * covered * 4 + n_seg * 4 + rows * n_seg * 4
    k4_ops = rows * covered

    trainer_numbers = trainer_phase(Path(ckpt_dir), counters)
    trainer_numbers["bench_refine_ms"] = statistics.median(bench_refine_ms)
    probe_kernels, probe_numbers = probes_phase(
        (k1_rec, isect.gaussian_ids, isect.tile_bins, tiles[0]), k1["ms"],
        k1_bytes, k1_ops)
    backend_numbers = backend_phase(Path(ckpt_dir), trainer_numbers)
    method_numbers = methods_phase(Path(ckpt_dir), counters)

    kernels = []
    for name, t, nbytes, ops, src, replaces, err in (
        ("segment_broadcast", k3, k3_bytes, k3_ops,
         "gstk_torch/csrc/segment_broadcast.cu",
         "gstk_tpu/ops/segment_kernel.py:57", 0.0),
        ("composite_tiles_fwd", k1, k1_bytes, k1_ops,
         "gstk_torch/csrc/composite_fwd.cu",
         "gstk_tpu/ops/raster_pallas.py:409", k1_err),
        ("composite_tiles_bwd", k2, k2_bytes, k2_ops,
         "gstk_torch/csrc/composite_bwd.cu",
         "gstk_tpu/ops/raster_pallas.py:661", k2_err),
        ("segment_sum_sorted", k4, k4_bytes, k4_ops,
         "gstk_torch/csrc/segment_sum.cu",
         "gstk_tpu/ops/segment_kernel.py:227", k4_err),
    ):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOP_PER_S * 1e3
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": step_launches[name],
            "max_abs_err": err, "max_err": err,
            "ms": t["ms"], "ms_per_call": t["ms_per_call"],
            "profiler_launches": t["profiler_launches"], "profiler_calls": iters,
            "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops,
            "library_ms": t["library_ms"],
        }
        if "library_axis1_ms" in t:
            entry["library_axis1_ms"] = t["library_axis1_ms"]
        if name in launches:
            entry["launches_render"] = launches[name]
        entry["launches_methods"] = {
            run: n[name] for run, n in method_numbers["launches"].items()}
        if name in resident:
            entry["resident_ctas_per_sm"] = resident[name][ch]
        kernels.append(entry)
    kernels.extend(probe_kernels)
    print(json.dumps({"kernels": kernels,
                      "train_tile_lengths": tile_lengths,
                      "train_kept_warp_entries": warp_entries,
                      "k4_segments": k4_segments, "k4_glue": k4_glue,
                      "floors": floors,
                      "pack_records": pack,
                      "request_ms_median": statistics.median(ms),
                      "request_ms_min": min(ms),
                      "train_step_ms_median": statistics.median(ms_steps),
                      "train_step_ms_min": min(ms_steps),
                      "trainer": trainer_numbers, "probes": probe_numbers,
                      "backend": backend_numbers,
                      "methods": method_numbers,
                      "power": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


def write_seed_cloud(data: Path, n: int) -> None:
    """Rewrite the dataset's ``sparse.ply`` with ``n`` seed points: each a
    point of the generator's own cloud, picked at random, moved by
    N(0, SEED_JITTER) on each axis, with that point's color. The generator
    writes the points of its object, as few as its fixed intersection
    buffer allows; the trainer starts from this cloud, at the size of
    phase 10's scene."""
    rng = np.random.default_rng(SEED)
    pts, rgb = read_ply_points(data / "sparse.ply")
    pick = rng.integers(0, len(pts), n)
    xyz = (pts[pick] + rng.normal(0.0, SEED_JITTER, (n, 3))).astype(np.float32)
    write_ply(data / "sparse.ply", {"vertex": {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "red": rgb[pick, 0], "green": rgb[pick, 1], "blue": rgb[pick, 2],
    }})


def trainer_phase(work_dir: Path, counters) -> dict:
    """Phase 11: the trainer's CLI on a synthetic dataset, in process."""
    phase("11 trainer path: gstk_torch.scripts.train, 400 steps at 800x800")
    t0 = time.perf_counter()
    data = generate_synthetic_dataset(
        work_dir / "synthetic", n_points=SYN_POINTS, n_views=SYN_VIEWS,
        img_wh=(W, H), seed=SEED, device=DEVICE,
    )
    write_seed_cloud(data, SEED_POINTS)
    print(f"synthetic dataset: {SYN_POINTS} points, {SYN_VIEWS} views at "
          f"{W}x{H}, no view over the generator's {ISECT_CAPACITY} "
          f"intersections (it raises otherwise); seed cloud {SEED_POINTS} "
          f"points; {time.perf_counter() - t0:.1f} s")
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    trainer = train_main([
        "--device", DEVICE, "gaussian-splatting", "--data", str(data),
        "--output-dir", str(work_dir / "runs"),
        "--max-num-iterations", str(TRAIN_ITERS),
        "--model.num-downscales", "0", "--model.sh-degree-interval", "100",
        "--model.warmup-length", "100", "--steps-per-eval-image", "100",
        "--steps-per-eval-all-images", "400", "--steps-per-save", "400",
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "8",
    ])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    print(f"trainer run {run_s:.1f} s (setup, {TRAIN_ITERS} steps, evals, "
          f"checkpoints); launches {launches}")
    for name, n in launches.items():
        assert n >= 1, f"{name} not launched by the trainer"

    run_dir = trainer.config.run_dir
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]
    col = lambda key: [(r["step"], r[key]) for r in rows if key in r]
    losses, alive = col("loss"), col("num_alive")
    assert losses and all(math.isfinite(v) for _, v in losses), "loss not finite"
    assert alive[0][1] != alive[-1][1], "num_alive never changed"
    images = col("eval_image_psnr")
    final_eval = col("eval_psnr")[-1]
    print(f"num_alive {alive[0][1]:.0f} -> {alive[-1][1]:.0f}; loss "
          f"{losses[0][1]:.5f} -> {losses[-1][1]:.5f}; eval_image PSNR "
          f"{[(s, round(v, 3)) for s, v in images]} (step, dB), final eval "
          f"PSNR {final_eval[1]:.3f} (step {final_eval[0]})")
    # the amortized wall time per step of each log window; the first holds
    # the caching of the train split
    iter_ms = [v * 1e3 for _, v in col("Train Iter (time)")][1:]
    step_ms = {"median": statistics.median(iter_ms), "min": min(iter_ms),
               "max": max(iter_ms), "windows": len(iter_ms)}
    print(f"trainer per-step wall time (ITER_TRAIN_TIME over "
          f"{len(iter_ms)} log windows after the first): median "
          f"{step_ms['median']:.3f} ms, min {step_ms['min']:.3f}, max "
          f"{step_ms['max']:.3f}")

    # the final checkpoint, rendered by the Renderer as the trainer renders it
    frame = trainer.datamanager.eval_frames[0]
    assert frame.image.shape == (H, W, 4)  # the generator writes RGBA
    gt = frame.image[..., :3] * frame.image[..., 3:] + (
        1.0 - frame.image[..., 3:]) * np.asarray(EVAL_BACKGROUND, np.float32)
    psnr = lambda pred: float(-10.0 * np.log10(np.mean((pred - gt) ** 2)))
    renderer = Renderer(run_dir, background=EVAL_BACKGROUND, device=DEVICE)
    out = renderer.get_output_from_pose(frame.c2w, frame.fx, frame.fy,
                                        frame.cx, frame.cy, H, W)
    assert np.isfinite(out["rgb"]).all() and out["accumulation"].mean() > 0.01
    ckpt_psnr = psnr(out["rgb"])
    own_psnr = psnr(trainer._render_eval(frame)["rgb"].cpu().numpy())
    print(f"checkpoint step {renderer.step} through Renderer: eval view 0 PSNR "
          f"{ckpt_psnr:.4f}, the trainer's own render {own_psnr:.4f}")
    assert abs(ckpt_psnr - own_psnr) < 0.01, "the checkpoint renders otherwise"
    del renderer

    frames = trainer.datamanager.eval_frames
    eval_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._score_views(frames)
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3 / len(frames))
    print(f"eval_all per view: {[round(x, 3) for x in eval_ms]} ms over "
          f"{len(frames)} views (synchronized)")

    trainer_vs_plain(trainer)
    cache_numbers = cache_check(trainer)
    png_numbers = png_check(work_dir)
    refine_numbers = refine_check(trainer)
    grow_numbers = grow_check(trainer)
    loaded = [m for m in ("PIL", "cv2", "yaml") if m in sys.modules]
    assert not loaded, f"the trainer path imported {loaded}"
    # read; left in place, the profiler's exit report would print after
    # the last line
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    assert final_eval[1] > images[0][1], (
        f"the final eval ({final_eval[1]:.3f} dB) is no better than the "
        f"first eval_image ({images[0][1]:.3f} dB at step {images[0][0]})")
    return {"launches": launches, "run_s": run_s, "step_ms": step_ms,
            "eval_all_ms_per_view": statistics.median(eval_ms),
            "num_alive": [alive[0][1], alive[-1][1]],
            "eval_image_psnr": images, "final_eval_psnr": final_eval[1],
            "final_eval_ssim": col("eval_ssim")[-1][1],
            **cache_numbers, **png_numbers, **refine_numbers, **grow_numbers}


def trainer_vs_plain(trainer) -> None:
    """One trainer step from the trained state through the kernels (the
    trainer's own step function) against the same step through the plain
    twins (``backend="plain"``, the trainer's raster config otherwise),
    from one carried-over state and one generator state (the random
    background), with phase 10's tolerances; then one eval render both
    ways, with phase 6's."""
    cfg = trainer.config
    step = int(trainer.state.step)
    sh = trainer._sh_degree(step)
    plain_raster = dataclasses.replace(trainer.raster_cfg, backend="plain")
    fns = (trainer._step_fn(H, W, sh, False),
           make_train_step(cfg.model, plain_raster, cfg.optim, H, W, sh))
    idx, frame = trainer.datamanager.next_train()
    inputs = trainer._train_inputs(idx, frame, 1)
    before = train_state_to_numpy(trainer.state)
    gen_state = trainer.generator.get_state()
    outs = []
    for fn in fns:
        gen = torch.Generator(device=DEVICE)
        gen.set_state(gen_state)
        s, m = fn(train_state_from_numpy(before, DEVICE), *inputs[:2], gen,
                  *inputs[2:])
        torch.cuda.synchronize()
        outs.append((train_state_to_numpy(s), m))
    (got, m_k), (want, m_p) = outs
    print(f"trainer step {step} ({int(m_k['num_intersects'])} intersections "
          f"of {trainer.raster_cfg.isect_capacity}):", end=" ")
    compare_steps(m_k, m_p, before, got, want, cfg.optim, step)

    frame = trainer.datamanager.eval_frames[0]
    setting = trainer._eval_setting()
    got = trainer._render_eval(frame, setting)
    saved, trainer.raster_cfg = trainer.raster_cfg, plain_raster
    want = trainer._render_eval(frame, setting)
    trainer.raster_cfg = saved
    errs = {}
    for k in ("rgb", "depth", "alpha"):
        assert_close(f"trainer eval render {k}", got[k], want[k], **PARITY)
        errs[k] = float((got[k] - want[k]).abs().max())
    print(f"trainer eval render vs plain twins: max abs err {errs}")


def refine_runs(flat, cfg, num_train, img_size, device, step=None,
                reps=1, noise=None):
    """``refine`` from the carried-over state ``flat`` on ``device`` at
    ``step`` (the state's when None), ``reps`` times, each from a fresh
    copy and synchronized; the noise is one seed-0 draw when not given.
    Returns the last state, its ``info`` and the times in ms."""
    if noise is None:
        cap = flat[".scene/.means"].shape[0]
        noise = torch.randn((cfg.n_split_samples, cap, 3),
                            generator=torch.Generator().manual_seed(SEED))
    step = int(flat[".step"]) if step is None else step
    ms = []
    for _ in range(reps):
        s = train_state_from_numpy(flat, device)
        n = noise.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, info = refine(s.scene, s.adam, s.refine, step, cfg,
                               num_train, img_size, noise=n)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return s, {k: v.item() for k, v in info.items()}, ms


def refine_check(trainer) -> dict:
    """``refine`` at the trained capacity: 20 more steps (timed one by
    one, synchronized) give it statistics, and one more, traced, the
    trainer step's device idle share; then from that state and one noise
    draw, on the card (timed, synchronized) and on the CPU, which must
    agree: equal alive masks and ``info``, parameters within rtol 1e-6
    (means within 1e-6 of the largest ``|mean|``: a child's mean sums its
    parent's and an offset whose ``exp`` rounds differently on the two
    devices)."""
    step_fn = trainer._step_fn(H, W, trainer._sh_degree(TRAIN_ITERS), False)
    step_ms = []
    for _ in range(20):
        idx, frame = trainer.datamanager.next_train()
        t0 = time.perf_counter()
        inputs = trainer._train_inputs(idx, frame, 1)
        trainer.state, _ = step_fn(trainer.state, *inputs[:2],
                                   trainer.generator, *inputs[2:])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"trainer step at the trained state: median "
          f"{statistics.median(step_ms):.3f} ms, min {min(step_ms):.3f} "
          f"(host clock, synchronized, 20 steps)")
    trace("trainer step", lambda: step_fn(trainer.state, *inputs[:2],
                                          trainer.generator, *inputs[2:]))
    flat = train_state_to_numpy(trainer.state)
    cap = trainer.state.scene.capacity
    args = (trainer.config.model, trainer.datamanager.num_train,
            max(trainer.datamanager.image_size))
    got, got_info, refine_ms = refine_runs(flat, *args, DEVICE,
                                           reps=REFINE_TIMES)
    want, want_info, cpu_ms = refine_runs(flat, *args, "cpu")
    print(f"refine at step {int(flat['.step'])}, capacity {cap}: card "
          f"{[round(x, 3) for x in refine_ms]} ms (synchronized), CPU "
          f"{cpu_ms[0]:.1f} ms; info {want_info}")
    assert got_info == want_info, f"refine info: card {got_info}, CPU {want_info}"
    assert want_info["num_split"] + want_info["num_dup"] > 0, "nothing densified"
    got, want = train_state_to_numpy(got), train_state_to_numpy(want)
    flips = int((got[".scene/.alive"] != want[".scene/.alive"]).sum())
    assert flips == 0, f"refine alive masks differ in {flips} lanes"
    means_atol = 1e-6 * float(np.abs(want[".scene/.means"]).max())
    worst = 0.0
    for k, v in want.items():
        atol = means_atol if k == ".scene/.means" else 1e-7
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=atol, err_msg=k)
        worst = max(worst, float(np.abs(got[k].astype(np.float64) - v).max()))
    print(f"refine card vs CPU: alive masks and info equal, max abs diff {worst:.3g}")
    return {"synced_step_ms": statistics.median(step_ms),
            "refine_ms": statistics.median(refine_ms),
            "refine_cpu_ms": cpu_ms[0], "refine_capacity": cap,
            "refine_alive": int(want[".scene/.alive"].sum()),
            "refine_info": want_info}


def grow_check(trainer) -> dict:
    """Each capacity growth of the run (host clock, from the trainer's
    profiler), then forced growths up to ``max_capacity`` (2^21 by
    default), each synchronized, and ``refine`` at that capacity."""
    grew = PROFILER.counts.get("grow_capacity", 0)
    in_run = PROFILER.totals.get("grow_capacity", 0.0) / max(grew, 1) * 1e3
    forced = []
    while trainer.state.scene.capacity < trainer.config.max_capacity:
        cap = trainer.state.scene.capacity
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._maybe_grow({"num_alive": cap, "num_intersects": 0})
        torch.cuda.synchronize()
        forced.append((cap, trainer.state.scene.capacity,
                       (time.perf_counter() - t0) * 1e3))
        assert trainer.state.scene.capacity > cap, "forced growth did not grow"
    print(f"capacity growth: {grew} in the run ({in_run:.3f} ms each, host "
          f"clock); forced after it (from, to, ms): {forced}")
    cap = trainer.state.scene.capacity
    _, info, ms = refine_runs(
        train_state_to_numpy(trainer.state), trainer.config.model,
        trainer.datamanager.num_train, max(trainer.datamanager.image_size),
        DEVICE, reps=REFINE_TIMES)
    print(f"refine at capacity {cap}: {[round(x, 3) for x in ms]} ms "
          f"(synchronized); info {info}")
    return {"grew_in_run": grew, "grow_in_run_ms": in_run if grew else None,
            "grow_forced_ms": forced, "refine_max_capacity": cap,
            "refine_max_capacity_ms": statistics.median(ms)}


def cache_check(trainer) -> dict:
    """The d = 4 bucket of the trained split (gs-train's default
    coarse-to-fine start; phase 11 trains at d = 1): built on the card
    after the d = 1 bucket is dropped, with the device peak over the bytes
    allocated before; the peak must stay under what the trainer's budget
    check counts (``train_cache_bytes``), and the bucket must equal the
    per-frame path and ``area_downscale`` of the whole stack bit for bit.
    Beside it, how far the build before the repair (the uint8 stack
    uploaded whole, divided by the host scalar 255, downscaled at once)
    lies from it."""
    frames = trainer.datamanager.train_frames
    shape = frames[0].image.shape
    checked = train_cache_bytes(len(frames), shape, 4,
                                frames[0].mask is not None,
                                frames[0].depth is not None)
    trainer._dev_cache = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, imgs, *_ = trainer._device_train_cache(4)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    kept = imgs.numel() * imgs.element_size()
    stack_np = np.stack([f.image for f in frames])
    full_stack = stack_np.size * 4
    print(f"train cache at d = 4: {len(frames)} frames {shape} -> "
          f"{tuple(imgs.shape)}, {build_ms:.1f} ms; device peak {peak / 2**20:.2f} "
          f"MiB over the {base / 2**20:.1f} MiB before, bucket {kept / 2**20:.2f} "
          f"MiB, checked {checked / 2**20:.2f} MiB, the full-resolution f32 "
          f"stack {full_stack / 2**20:.2f} MiB")
    assert peak <= checked, f"the build peaked at {peak} B over the {checked} B checked"
    for i in (0, len(frames) - 1):
        gt = trainer._frame_to_device(frames[i], 4)[1]
        assert torch.equal(imgs[i], gt), f"bucket frame {i} differs from the per-frame path"
    stack = torch.from_numpy(stack_np).to(DEVICE)
    assert torch.equal(imgs, area_downscale(stack, 4)), (
        "the bucket differs from area_downscale of the whole stack")
    before = torch.from_numpy(np.rint(stack_np * 255).astype(np.uint8)).to(DEVICE)
    before = area_downscale(before.to(torch.float32) / 255.0, 4)
    diff = float((imgs - before).abs().max())
    print(f"bucket equals the per-frame path and one product over the stack; "
          f"the build before the repair differs by up to {diff:.3g}")
    del stack, before, imgs
    trainer._dev_cache = {}
    return {"cache_d4": {"peak_bytes": peak, "checked_bytes": checked,
                         "bucket_bytes": kept, "full_stack_bytes": full_stack,
                         "build_ms": build_ms, "before_repair_max_diff": diff}}


def png_check(work_dir: Path) -> dict:
    """``read_png`` on an 800x800 RGB PNG of photo-like content whose rows
    are all Paeth-filtered, built here with numpy and zlib (the card's
    machine has no Pillow): bit-exact, and its host time (median of 3)."""
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:H, 0:W]
    shade = 60.0 * np.sin(0.05 * xx + 0.03 * yy)[..., None] * [1.0, 0.8, 0.6]
    img = np.clip(128 + shade + rng.normal(0, 2, (H, W, 3)), 0, 255).astype(np.uint8)
    x = img.reshape(H, -1).astype(np.int16)
    a = np.pad(x, ((0, 0), (3, 0)))[:, :-3]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(a, ((1, 0), (0, 0)))[:-1]  # up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((H, 1), 4, np.uint8),
                           ((x - pred) % 256).astype(np.uint8)], axis=1)
    chunk = lambda tag, data: (len(data).to_bytes(4, "big") + tag + data
                               + zlib.crc32(tag + data).to_bytes(4, "big"))
    path = work_dir / "paeth.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", W.to_bytes(4, "big") + H.to_bytes(4, "big")
                             + bytes([8, 2, 0, 0, 0]))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                     + chunk(b"IEND", b""))
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = read_png(path)
        ms.append((time.perf_counter() - t0) * 1e3)
    assert np.array_equal(got, img), "read_png differs on the Paeth PNG"
    print(f"read_png, {W}x{H} RGB, every row Paeth: bit-exact, "
          f"{[round(v, 2) for v in ms]} ms (host clock)")
    return {"read_png_paeth_ms": statistics.median(ms)}


def check_ablation(records, gids, bins, tiles_x, variants) -> dict:
    """Each P1 clone in ``variants`` against its plain twin on the card
    (rtol 1e-3 / atol 1e-4; ``dmaonly``, whose sum the twin takes in the
    kernel's order, rtol 1e-6), ``full`` and ``marg_none`` against K1 and
    ``noexit`` against ``full`` bit for bit. Returns each clone's largest
    difference from its twin."""
    xys, conics, op, colors = (records[:, 0:2], records[:, 2:5], records[:, 5],
                               records[:, 6:6 + ablate_fwd.KERNEL_CH])
    tiles = (tiles_x, bins.shape[0] // tiles_x)
    k1_out = composite_tiles_fwd(xys, conics, op, colors, gids, bins, tiles,
                                 records=records)
    outs, errs = {}, {}
    for variant in variants:
        outs[variant] = ablate_fwd.run_variant(variant, records, gids, bins, tiles_x)
        twin = ablate_fwd.ablate_fwd_plain(variant, records, gids, bins, tiles_x)
        tol = dict(rtol=1e-6, atol=0.0) if variant == "dmaonly" else PARITY
        for name, got, want in zip(("acc", "final_t"), outs[variant], twin):
            assert_close(f"P1 {variant} {name}", got, want, **tol)
        errs[variant] = max(float((g - w).abs().max())
                            for g, w in zip(outs[variant], twin))
    for variant, ref in (("full", k1_out), ("marg_none", k1_out),
                         ("noexit", outs["full"])):
        if variant in outs:
            assert all(torch.equal(g, w) for g, w in zip(outs[variant], ref)), (
                f"P1 {variant} is not bit-identical to its reference")
    return errs


def probes_phase(k1_render, k1_ms, k1_bytes, k1_ops):
    """Phase 12: the probes' entry points with their launch counters reset
    just before (P1 at the tool's two shapes, P2 and P3 at n = 2^20), then
    P1's checks at both shapes and ``full``, ``noexit`` and ``dmaonly`` on
    K1's render inputs ``k1_render`` (records, gids, tile bins, tiles_x)
    beside K1's time. Returns the probes' ``kernels`` entries and the
    numbers behind them."""
    phase("12 probes: P1 K1 ablation clones, P2 and P3 row scatters")
    counters = (ablate_fwd.run_variant, bench_dynrow.local_perm,
                bench_dynrow.dynwrite)
    for f in counters:
        f.launches = 0
    p1 = ablate_fwd.main(["--device", DEVICE])
    p23 = bench_dynrow.main(["--device", DEVICE])
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counters}
    print(f"launches in the probes' run: {launches}")
    for name, n in launches.items():
        assert n >= 1, f"{name} not launched by the probes"
    assert sum(r["launches"] for r in p1.values()) == launches["run_variant"]

    ch = ablate_fwd.KERNEL_CH
    bound = lambda nbytes, ops: max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3
    bound_by = lambda nbytes, ops: ("bytes" if nbytes / HBM_BYTES_PER_S
                                    >= ops / F32_FLOP_PER_S else "operations")
    entries, numbers = [], {"p1": {}, "p23": {}}
    for c_per_tile, shape in p1.items():
        records, gids, bins, tiles_x = ablate_fwd.probe_scene(c_per_tile, device=DEVICE)
        errs = check_ablation(records, gids, bins, tiles_x, ablate_fwd.VARIANTS)
        tiles = (tiles_x, 1)
        xys, conics, op, colors = (records[:, 0:2], records[:, 2:5], records[:, 5],
                                   records[:, 6:6 + ch])
        _, _, visited = composite_tiles_fwd_plain(xys, conics, op, colors, gids,
                                                  bins, tiles)
        pairs = int(visited.sum())
        assert pairs == gids.shape[0] * 256, "a pixel of the probe scene stopped"
        nbytes = (gids.shape[0] * (4 + 4 * (6 + ch)) + tiles_x * 8
                  + tiles_x * 256 * (ch + 1) * 4)
        ops = pairs * K1_FLOP_PER_PAIR
        variants_ms = {v: t["ms"] for v, t in shape["variants"].items()}
        plain_ms = event_ms(lambda: ablate_fwd.ablate_fwd_plain(
            "full", records, gids, bins, tiles_x), 1)
        label = f"T={tiles_x} C={c_per_tile}"
        print(f"P1 {label}: every clone within its twin's tolerance "
              f"{ {v: f'{e:.3g}' for v, e in errs.items()} }; full and "
              f"marg_none equal K1, noexit equals full; {pairs} pairs; ms "
              f"{ {v: round(m, 5) for v, m in variants_ms.items()} }")
        entries.append({
            "name": f"ablate_fwd {label}", "route": "cuda",
            "source": "gstk_torch/csrc/ablate_fwd.cu",
            "replaces": "tools/ablate_fwd.py:34", "launches": shape["launches"],
            "max_abs_err": errs["full"], "max_err": max(errs.values()),
            "ms": variants_ms["full"], "variants_ms": variants_ms,
            "plain_ms": plain_ms, "bound_ms": bound(nbytes, ops),
            "bound_by": bound_by(nbytes, ops), "bytes": nbytes,
            "operations": ops, "library_ms": None,
        })
        numbers["p1"][label] = {"variants_ms": variants_ms, "errors": errs,
                                "pairs": pairs}

    # K1's gap at the render point: staging floor and loop control
    records, gids, bins, tiles_x = k1_render
    render_vars = ("full", "noexit", "dmaonly")
    errs = check_ablation(records, gids, bins, tiles_x, render_vars)
    render_ms = {v: kernel_device_ms(
        lambda v=v: ablate_fwd.run_variant(v, records, gids, bins, tiles_x),
        "ablate_fwd_kernel", 20)["ms"] for v in render_vars}
    gap = {"k1_ms": k1_ms, "variants_ms": render_ms, "errors": errs,
           "bound_ms": bound(k1_bytes, k1_ops),
           "staging_share": render_ms["dmaonly"] / render_ms["full"],
           "noexit_minus_full_ms": render_ms["noexit"] - render_ms["full"]}
    print(f"P1 at the render point: {gap}")
    numbers["p1"]["render point"] = gap

    for tag, r in p23.items():
        if tag == "A_gather":
            numbers["p23"][tag] = {"ms": r["library"]["ms"]}
            continue
        R, rows = r["case"]
        n = bench_dynrow.ROWS_CARD
        nbytes = n * bench_dynrow.ROW * 4 * 2 + n // rows * 4
        kind, label = (("local_perm", f"R={R} g={rows}") if tag.startswith("B")
                       else ("dynwrite", f"R={R} W={rows}"))
        entries.append({
            "name": f"{kind} {label}", "route": "cuda",
            "source": "gstk_torch/csrc/dynrow.cu",
            "replaces": ("tools/bench_dynrow.py:103" if kind == "local_perm"
                         else "tools/bench_dynrow.py:193"),
            "launches": r["launches"], "max_abs_err": 0.0, "max_err": 0.0,
            "ms": r["kernel"]["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound(nbytes, 0), "bound_by": "bytes", "bytes": nbytes,
            "operations": 0, "library_ms": r["library"]["ms"],
            "gather_ms": p23["A_gather"]["library"]["ms"],
        })
        numbers["p23"][tag] = {k: entries[-1][k] for k in
                               ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"P2 / P3 (ms): {numbers['p23']}")
    return entries, numbers


def backend_phase(work_dir: Path, trained: dict) -> dict:
    """Phase 13: gs-eval, gs-render and gs-export on phase 11's run
    directory (its step-400 checkpoint), through the CLIs' ``main``."""
    phase("13 back end: gs-eval, gs-render and gs-export on phase 11's run")
    run_dir = work_dir / "runs" / "synthetic" / "gaussian-splatting"
    out = work_dir / "backend"
    out.mkdir()
    counters = (composite_tiles_fwd, segment_broadcast)
    numbers = {**eval_check(run_dir, out, trained, counters),
               **render_check(run_dir, out, counters),
               **export_check(run_dir, out)}
    loaded = [m for m in ("PIL", "cv2", "yaml", "torchvision", "transformers")
              if m in sys.modules]
    assert not loaded, f"the back end imported {loaded}"
    return numbers


def methods_phase(work_dir: Path, counters) -> dict:
    """Phase 14: co-gs, surface-gs and camera optimisation on phase 11's
    dataset (800x800, 21 train views, the 100k-point seed cloud in 2^19
    lanes), each path driven with the launch counters reset just before
    and read just after."""
    phase("14 methods: a co-gs + camera-opt step vs plain, co-gs and "
          "surface-gs through gs-train")
    t0 = time.perf_counter()
    data = work_dir / "synthetic"
    trainer, cogs = cogs_run(work_dir, data, counters)
    step = methods_step(trainer, counters)
    del trainer
    surface = surface_run(work_dir, data, counters)
    launches = {"co_gs_step": step.pop("launches"),
                "co_gs_run": cogs.pop("launches"),
                "surface_gs_run": surface.pop("launches")}
    # read; left in place, the profiler's exit report would print after
    # the last line
    PROFILER.totals.clear()
    PROFILER.counts.clear()
    wall_s = time.perf_counter() - t0
    print(f"phase 14 wall time {wall_s:.1f} s")
    return {"step": step, "co_gs": cogs, "surface_gs": surface,
            "launches": launches, "wall_s": wall_s}


def methods_step(trainer, counters) -> dict:
    """Phase 14(a): from the co-gs run's trained state (step 300, so with
    anisotropic scales: at the isotropic kNN init a Gaussian's covariance
    does not depend on its rotation, the rotations' gradient is exactly 0
    and both steps give rounding noise there), one co-gs step through the
    kernels against the same step through the plain twins (``backend=
    "plain"``), with phase 10's tolerances: sensor depth L1, the sparse term
    and the planar term (patches of ``PLANAR_PATCH``), SO3xR3 camera
    optimisation over the 21 train views; both steps draw the background and
    the patch origins from generators of one seed. K1-K4 launch once; K2's
    depth column is nonzero, the camera group's gradient finite and
    nonzero, no moment non-finite. Then the step timed and traced beside
    the vanilla method's step from the same state, and ``torch.linalg.eigh``
    on (16, 3, 3) covariances timed."""
    cfg = trainer.config
    model = dataclasses.replace(
        cfg.model, depth_loss_start_iteration=0, planar_loss_start_iteration=0,
        use_sparse_loss=True, using_planar_loss=True,
        local_patch_size=PLANAR_PATCH)
    state = trainer.state
    step = int(state.step)
    n_train = trainer.datamanager.num_train
    assert step % 100 == 0 and state.cam_adjust.shape == (n_train, 6)
    print(f"co-gs state: step {step}, {n_train} train views, capacity "
          f"{state.scene.capacity}, {int(state.scene.num_alive)} alive")
    sh = trainer._sh_degree(step)
    idx, frame = trainer.datamanager.next_train()
    inputs = trainer._train_inputs(idx, frame, 1)
    assert inputs[3] is not None, "the dataset has no sensor depth"
    index = trainer._camera_index(idx)
    kernel_fn = make_train_step(model, trainer.raster_cfg, cfg.optim, H, W, sh,
                                camera_opt=cfg.camera_opt)
    plain_fn = make_train_step(
        model, dataclasses.replace(trainer.raster_cfg, backend="plain"),
        cfg.optim, H, W, sh, camera_opt=cfg.camera_opt)
    before = train_state_to_numpy(state)
    run_step = lambda fn, st: fn(
        st, *inputs[:2], torch.Generator(device=DEVICE).manual_seed(SEED),
        *inputs[2:], camera_index=index)

    rast = importlib.import_module("gstk_torch.ops.rasterize")
    k2_rows = []

    def k2_recorded(*args, **kwargs):
        rows = composite_tiles_bwd(*args, **kwargs)
        k2_rows.append(rows)
        return rows

    state_k = train_state_from_numpy(before, DEVICE)
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    rast.composite_tiles_bwd = k2_recorded
    try:
        state_k, m_k = run_step(kernel_fn, state_k)
        torch.cuda.synchronize()
    finally:
        rast.composite_tiles_bwd = composite_tiles_bwd
    launches = launches_of(counters)
    state_p, m_p = run_step(plain_fn, train_state_from_numpy(before, DEVICE))
    torch.cuda.synchronize()
    print(f"launches in one co-gs + camera-opt step: {launches}")
    for name, n in launches.items():
        assert n == 1, f"{name} launched {n} times by the co-gs step"
    got, want = train_state_to_numpy(state_k), train_state_to_numpy(state_p)
    bad = [k for k, v in got.items()
           if v.dtype.kind == "f" and not np.isfinite(v).all()]
    assert not bad, f"non-finite after the co-gs step: {bad}"
    print(f"co-gs step {step} (view {idx}, {int(m_k['num_intersects'])} "
          f"intersections):", end=" ")
    compare_steps(m_k, m_p, before, got, want, cfg.optim, step)
    terms = {}
    for k in ("sparse_loss", "depth_l1", "planar_loss"):
        a, b = float(m_k[k]), float(m_p[k])
        assert a != 0.0 and math.isclose(a, b, rel_tol=1e-3), (
            f"{k}: {a} vs plain {b}")
        terms[k] = [a, b]

    # K2's rows of this step: the depth channel carries a gradient
    (rows,) = k2_rows
    col_max = rows.abs().amax(0).tolist()
    depth_nonzero = int((rows[:, K2_DEPTH_COLUMN] != 0).sum())
    assert depth_nonzero > 0, "K2's depth column is zero in the co-gs step"
    # the camera group's gradient, from its first moment before and after
    cam_key = ".cam_adam/.mu/['camera_opt']"
    b1 = cfg.optim.b1
    cam_grad = (got[cam_key] - b1 * before[cam_key]) / (1.0 - b1)
    assert np.isfinite(cam_grad).all() and np.abs(cam_grad[idx]).max() > 0, (
        "the camera adjustment got no gradient")
    cam_scale = 1e-4 * max(float(np.abs(want[cam_key]).max()), 1e-30)
    cam_bad = int((~np.isclose(got[cam_key], want[cam_key], rtol=RTOL_GRAD,
                               atol=cam_scale)).sum())
    assert cam_bad == 0, f"camera moments: {cam_bad} outside the tolerance"
    d_k = got[".cam_adjust"] - before[".cam_adjust"]
    d_p = want[".cam_adjust"] - before[".cam_adjust"]
    co = cfg.camera_opt
    cam_lr = float(OptimizerConfig(
        lrs=(("camera_opt", co.lr),),
        extra_exp=(("camera_opt", co.lr_final, co.max_steps),),
    ).schedule_for("camera_opt")(torch.tensor(step)))
    strong = np.abs(want[cam_key]) > 1e-3 * np.abs(want[cam_key]).max()
    cam_upd = np.where(strong, ~np.isclose(d_k, d_p, rtol=RTOL_GRAD, atol=0.0),
                       np.abs(d_k - d_p) > 2.0 * cam_lr + 1e-7)
    assert not cam_upd.any(), "camera adjustment updates differ"
    print(f"co-gs terms (kernel, plain): {terms}; K2 column max |g| "
          f"{[round(x, 6) for x in col_max]}, depth column nonzero in "
          f"{depth_nonzero} of {rows.shape[0]} rows; camera gradient of view "
          f"{idx} {cam_grad[idx].tolist()}")

    # the step timed and traced beside the vanilla method's step from the
    # same state, and each with the depth terms or the camera group alone
    vanilla = VanillaConfig(**{f.name: getattr(model, f.name)
                               for f in dataclasses.fields(VanillaConfig)})
    plain_state = {k: v for k, v in before.items() if not k.startswith(".cam")}
    timed = {}
    for label, variant, camera in (
        ("vanilla", vanilla, False), ("vanilla + camera", vanilla, True),
        ("co-gs terms", model, False), ("co-gs terms + camera", model, True),
    ):
        fn = make_train_step(variant, trainer.raster_cfg, cfg.optim, H, W, sh,
                             camera_opt=cfg.camera_opt if camera else None)
        st = train_state_from_numpy(before if camera else plain_state, DEVICE)
        call = lambda fn=fn, st=st, camera=camera: fn(
            st, *inputs[:2], torch.Generator(device=DEVICE).manual_seed(SEED),
            *inputs[2:], camera_index=index if camera else None)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        timed[label] = {"ms_median": statistics.median(ms), "ms_min": min(ms),
                        "traced": trace(f"{label} step", call)}
        print(f"{label} step ms: median {timed[label]['ms_median']:.3f}, min "
              f"{timed[label]['ms_min']:.3f} (host clock, synchronized, 5 steps)")
    base = timed["vanilla"]
    added = {label: {"device_events": t["traced"]["device_events"]
                     - base["traced"]["device_events"],
                     "busy_ms": t["traced"]["busy_ms"] - base["traced"]["busy_ms"],
                     "ms_median": t["ms_median"] - base["ms_median"]}
             for label, t in timed.items() if label != "vanilla"}
    print(f"added to the vanilla step: {added}")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pts = torch.randn((16, PLANAR_PATCH * PLANAR_PATCH, 3), generator=gen,
                      device=DEVICE)
    cov = pts.transpose(1, 2) @ pts / pts.shape[1]
    eigh = {"device": kernel_device_ms(lambda: torch.linalg.eigh(cov), None, 20),
            "events_ms": event_ms(lambda: torch.linalg.eigh(cov), 20)}
    host_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        torch.linalg.eigh(cov)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    eigh["host_ms_median"] = statistics.median(host_ms)
    print(f"torch.linalg.eigh on (16, 3, 3): {eigh}")
    return {"launches": launches, "terms": terms, "k2_column_max": col_max,
            "k2_depth_nonzero_rows": depth_nonzero, "view": idx,
            "camera_grad": cam_grad[idx].tolist(), "timed": timed,
            "added_by_methods": added, "eigh": eigh}


def method_run(work_dir: Path, data: Path, counters, method: str,
               extra: list):
    """``gstk_torch.scripts.train <method>`` for ``METHOD_ITERS`` steps on
    phase 11's dataset, in process, with the launch counters reset just
    before: K1-K4 launch and the losses stay finite. Returns the trainer,
    the numbers printed and the metrics as ``col(key) -> [(step,
    value)]``."""
    PROFILER.totals.clear()  # the run's own report
    PROFILER.counts.clear()
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    trainer = train_main([
        "--device", DEVICE, method, "--data", str(data),
        "--output-dir", str(work_dir / "methods"),
        "--max-num-iterations", str(METHOD_ITERS), "--steps-per-eval-image",
        "0", "--steps-per-eval-all-images", str(METHOD_ITERS),
        "--steps-per-save", str(METHOD_ITERS),
        "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "8",
        *extra,
    ])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = launches_of(counters)
    for name, n in launches.items():
        assert n >= 1, f"{name} not launched by {method}"
    rows = [json.loads(line) for line in
            (trainer.config.run_dir / "metrics.jsonl").open()]
    col = lambda key: [(r["step"], r[key]) for r in rows if key in r]
    losses = col("loss")
    assert losses and all(math.isfinite(v) for _, v in losses), "loss not finite"
    final_eval = col("eval_psnr")[-1][1]
    assert math.isfinite(final_eval)
    # the first log window holds the setup
    iter_ms = [v * 1e3 for _, v in col("Train Iter (time)")][1:]
    numbers = {"launches": launches, "run_s": run_s,
               "step_ms_median": statistics.median(iter_ms),
               "final_eval_psnr": final_eval, "loss": [losses[0], losses[-1]]}
    print(f"{method}: {METHOD_ITERS} steps in {run_s:.1f} s (setup, steps, "
          f"evals, checkpoint); {numbers}")
    return trainer, numbers, col


def cogs_run(work_dir: Path, data: Path, counters):
    """Phase 14(b): co-gs with sensor depth from step 0 and SO3xR3 camera
    optimisation; the camera adjustments finite and moved. Reports the
    depth-L1 term at the first log past its gate (step 0 is shut) and the
    last. Returns the trainer and the numbers."""
    trainer, numbers, col = method_run(work_dir, data, counters, "co-gs", [
        "--model.depth-loss-start-iteration", "0",
        "--camera-opt.mode", "SO3xR3"])
    adj = trainer.state.cam_adjust
    assert adj is not None and bool(torch.isfinite(adj).all())
    moved = float(adj.abs().max())
    assert moved > 0, "the camera adjustments never moved"
    depth = [(st, v) for st, v in col("depth_l1") if st > 0]
    numbers.update(depth_l1=[depth[0], depth[-1]], cam_adjust_max=moved,
                   camera_opt=[col("camera_opt_translation")[-1],
                               col("camera_opt_rotation")[-1]])
    print(f"co-gs: depth_l1 (step, value) {numbers['depth_l1']}, camera "
          f"adjustments max |x| {moved:.3g}, (translation, rotation) "
          f"{numbers['camera_opt']}")
    return trainer, numbers


def surface_run(work_dir: Path, data: Path, counters) -> dict:
    """Phase 14(c): surface-gs for ``METHOD_ITERS`` steps through the
    coarse-to-fine schedule (``num_downscales`` 2, a bucket every
    ``SURFACE_SCHEDULE`` steps: d = 4, 2, 1), refining from step 100; the
    means of every lane still alive equal the seed cloud's bit for bit,
    no refine splits or duplicates, no lane past the seed comes alive; the
    step time of each bucket (the median of its log windows, the window
    with its cache build left out)."""
    infos = []
    refine = trainer_mod.refine

    def recorded(*args, **kwargs):
        out = refine(*args, **kwargs)
        infos.append(out[3])
        return out

    trainer_mod.refine = recorded
    try:
        trainer, numbers, col = method_run(work_dir, data, counters, "surface-gs", [
            "--model.resolution-schedule", str(SURFACE_SCHEDULE),
            "--model.warmup-length", str(SURFACE_SCHEDULE)])
    finally:
        trainer_mod.refine = refine
    scene = trainer.state.scene
    pts = trainer.datamanager.seed_points()[0]
    n = pts.shape[0]
    alive = scene.alive.detach()
    assert not bool(alive[n:].any()), "a lane past the seed cloud came alive"
    seed = torch.from_numpy(np.asarray(pts, np.float32)).to(DEVICE)
    kept = alive[:n]
    assert torch.equal(scene.means.detach()[:n][kept], seed[kept]), (
        "surface-gs moved an alive mean")
    info = {k: sum(int(i[k]) for i in infos)
            for k in ("num_split", "num_dup", "num_cull")}
    assert infos and info["num_split"] == 0 and info["num_dup"] == 0, (
        f"surface-gs densified: {info}")
    downscales = trainer.config.model.num_downscales
    buckets = {}
    for k in range(downscales + 1):
        lo = k * SURFACE_SCHEDULE
        ms = [v * 1e3 for st, v in col("Train Iter (time)")
              if lo < st < lo + SURFACE_SCHEDULE]
        buckets[f"d={2 ** (downscales - k)}"] = {
            "ms_median": statistics.median(ms), "windows": len(ms)}
    print(f"surface-gs: {int(kept.sum())} of {n} seed lanes alive, their means "
          f"bit-equal to the seed's; {len(infos)} refines: {info}; step ms by "
          f"bucket {buckets}")
    numbers.update(alive=[n, int(kept.sum())], refines=len(infos), refine=info,
                   step_ms_by_bucket=buckets)
    return numbers


def launches_of(counters) -> dict:
    return {f.__name__: f.launches for f in counters}


def check_eval(name, got, want) -> None:
    """gs-eval's mean PSNR within rtol EVAL_RTOL and SSIM within atol
    EVAL_ATOL of ``want``'s (``{"psnr", "ssim"}``, or another gs-eval JSON,
    whose per-view lists are then held alike)."""
    mean = lambda r: r["results"] if "results" in r else r
    pairs = [(mean(got)["psnr"], mean(want)["psnr"], EVAL_RTOL, 0.0),
             (mean(got)["ssim"], mean(want)["ssim"], 0.0, EVAL_ATOL)]
    if "per_image" in want:
        for k, rtol, atol in (("psnr", EVAL_RTOL, 0.0), ("ssim", 0.0, EVAL_ATOL)):
            assert len(got["per_image"][k]) == len(want["per_image"][k])
            pairs += [(a, b, rtol, atol) for a, b in
                      zip(got["per_image"][k], want["per_image"][k])]
    for a, b, rtol, atol in pairs:
        assert math.isfinite(a) and abs(a - b) <= atol + rtol * abs(b), (
            f"{name}: {a} against {b}")


@contextlib.contextmanager
def tf32_convolutions():
    """cuDNN's default TF32 convolutions, with the package's f32 guard
    bypassed: what SSIM computed before the guard."""
    saved = torch.backends.cudnn.allow_tf32, losses.f32_convolutions
    torch.backends.cudnn.allow_tf32 = True
    losses.f32_convolutions = contextlib.nullcontext
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, losses.f32_convolutions = saved


def eval_check(run_dir: Path, out: Path, trained: dict, counters) -> dict:
    """gs-eval in process (device loop and host loop), in a fresh
    ``python -m`` process under PyTorch's default TF32 flags, and with
    LPIPS weights; the device loop timed and one view traced."""
    cfg = str(run_dir / "config.yml")
    argv = lambda name, *extra: ["--load-config", cfg, "--output-path",
                                 str(out / name), *extra]
    want = {"psnr": trained["final_eval_psnr"], "ssim": trained["final_eval_ssim"]}
    for f in counters:
        f.launches = 0
    res = eval_cli.main(argv("eval.json", "--skip-lpips"))
    torch.cuda.synchronize()
    launches = launches_of(counters)
    n = res["results"]["num_images"]
    print(f"gs-eval: {n} views, PSNR {res['results']['psnr']:.6f} SSIM "
          f"{res['results']['ssim']:.6f} (the trainer's final eval: PSNR "
          f"{want['psnr']:.6f} SSIM {want['ssim']:.6f}); launches {launches}")
    assert n == SYN_VIEWS // 8 and res["results"]["lpips"] is None
    assert all(v == n for v in launches.values()), "K1 / K3 not once a view"
    check_eval("gs-eval vs the trainer's eval", res, want)
    host = eval_cli.main(argv("eval_host.json", "--skip-lpips", "--force-host-loop"))
    check_eval("--force-host-loop", host, res)
    proc = subprocess.run(
        [sys.executable, "-m", "gstk_torch.scripts.eval",
         *argv("eval_sub.json", "--skip-lpips")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    sub = json.loads((out / "eval_sub.json").read_text())
    check_eval("gs-eval in a fresh process", sub, res)
    assert {k: v for k, v in sub.items() if k not in ("results", "per_image")} == {
        k: v for k, v in res.items() if k not in ("results", "per_image")}
    print(f"gs-eval --force-host-loop and in a fresh process (default TF32 "
          f"flags): PSNR {host['results']['psnr']:.6f} / "
          f"{sub['results']['psnr']:.6f}, SSIM {host['results']['ssim']:.6f} / "
          f"{sub['results']['ssim']:.6f}")

    config = load_config(run_dir / "config.yml")
    renderer = Renderer(run_dir / "ckpts", model_config=config.model,
                        background=EVAL_BACKGROUND, device=DEVICE)
    frames = FullImageDatamanager(config.dataparser, seed=config.seed,
                                  splits=("eval",)).eval_frames
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_cli.batched_eval(renderer, frames)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / len(frames))
    print(f"gs-eval device loop: {[round(x, 3) for x in ms]} ms a view "
          f"(synchronized, {len(frames)} views)")
    traced = trace("gs-eval view", lambda: eval_cli.batched_eval(renderer, frames[:1]),
                   top=10)

    frame = frames[0]
    h, w = frame.image.shape[:2]
    with torch.no_grad():
        pred = renderer.render(frame.c2w, frame.fx, frame.fy, frame.cx, frame.cy,
                               h, w)["rgb"]
    gt = torch.from_numpy(composite_gt_with_background(
        frame.image, np.asarray(EVAL_BACKGROUND, np.float32))).to(DEVICE)
    ssim_f32 = float(losses.ssim(gt, pred))
    with tf32_convolutions():
        ssim_tf32 = float(losses.ssim(gt, pred))
    print(f"SSIM of eval view 0: {ssim_f32:.8f} in f32, {ssim_tf32:.8f} with "
          f"cuDNN's TF32 (the package's guard bypassed), diff "
          f"{ssim_tf32 - ssim_f32:.3g}")

    params = random_lpips_params(SEED, device="cpu")
    weights = out / "lpips.npz"
    np.savez(weights, **{k: v.numpy() for k, v in params.items()})
    lp = eval_cli.main(argv("eval_lpips.json", "--lpips-weights", str(weights)))
    value = lp["results"]["lpips"]
    assert value is not None and math.isfinite(value) and value > 0, value
    check_eval("gs-eval with LPIPS", lp, res)
    card_params = {k: v.to(DEVICE) for k, v in params.items()}
    ms_lpips = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_cli.batched_eval(renderer, frames, card_params)
        torch.cuda.synchronize()
        ms_lpips.append((time.perf_counter() - t0) * 1e3 / len(frames))
    y0, x0 = (h - LPIPS_CROP) // 2, (w - LPIPS_CROP) // 2
    crop = lambda x: x[y0:y0 + LPIPS_CROP, x0:x0 + LPIPS_CROP].contiguous()
    lp_card = float(lpips(card_params, crop(gt), crop(pred)))
    lp_cpu = float(lpips(params, crop(gt).cpu(), crop(pred).cpu()))
    err = abs(lp_card - lp_cpu) / abs(lp_cpu)
    print(f"LPIPS (random weights, npz): gs-eval {value:.6g} over {n} views, "
          f"{[round(x, 3) for x in ms_lpips]} ms a view with LPIPS; on a "
          f"{LPIPS_CROP}^2 crop of view 0 card {lp_card:.8g}, CPU {lp_cpu:.8g}, "
          f"rel err {err:.3g}")
    assert err <= 1e-4, "LPIPS on the card differs from the CPU"
    return {"eval": {"views": n, "launches": launches,
                     "launches_per_view": {k: v / n for k, v in launches.items()},
                     "psnr": res["results"]["psnr"], "ssim": res["results"]["ssim"],
                     "trainer_psnr": want["psnr"], "trainer_ssim": want["ssim"],
                     "subprocess_psnr": sub["results"]["psnr"],
                     "subprocess_ssim": sub["results"]["ssim"],
                     "ms_per_view": statistics.median(ms), "traced_view": traced,
                     "ssim_f32": ssim_f32, "ssim_tf32": ssim_tf32,
                     "lpips": value, "lpips_ms_per_view": min(ms_lpips),
                     "lpips_crop_rel_err": err}}


def record_bands(fn) -> list:
    """Run ``fn`` with ``bin_gaussians`` recorded: per band, its tile count,
    true intersection count and the last tile range's end."""
    rasterize_mod = importlib.import_module("gstk_torch.ops.rasterize")
    inner, seen = rasterize_mod.bin_gaussians, []

    def recorded(*args, **kw):
        isect = inner(*args, **kw)
        bins = isect.tile_bins
        seen.append({"tiles": int(bins.shape[0]),
                     "num_intersects": int(isect.num_intersects),
                     "capacity": int(isect.gaussian_ids.shape[0]),
                     "last_end": int(bins[:, 1].max()),
                     "ordered": bool((bins[:, 0] <= bins[:, 1]).all()
                                     and (bins[1:, 0] >= bins[:-1, 1]).all())})
        return isect

    rasterize_mod.bin_gaussians = recorded
    try:
        fn()
    finally:
        rasterize_mod.bin_gaussians = inner
    return seen


def render_check(run_dir: Path, out: Path, counters) -> dict:
    """gs-render pose (every file read back against the Renderer's output,
    quantized alike) and trajectory (8 poses at 1920x1080, four bands: K1
    and K3 four times a frame, one frame against the plain twins)."""
    cfg = str(run_dir / "config.yml")
    config = load_config(run_dir / "config.yml")
    dm = FullImageDatamanager(config.dataparser, seed=config.seed)
    train = dm.train_frames
    pose_dir = out / "pose"
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    render_cli.main(["pose", "--load-config", cfg, "--output-dir", str(pose_dir)])
    torch.cuda.synchronize()
    pose_s = time.perf_counter() - t0
    launches = launches_of(counters)
    assert all(v == len(train) for v in launches.values()), launches
    for sub in ("rgb", "depth", "gt/rgb", "gt/depth"):
        assert len(list((pose_dir / sub).glob("*.png"))) == len(train), sub
    poses = json.loads((pose_dir / "poses.json").read_text())
    assert len(poses) == len(train)
    renderer = Renderer(run_dir / "ckpts", model_config=config.model, device=DEVICE)
    for i, frame in enumerate(train):
        o = renderer.get_output_from_pose(frame.c2w, frame.fx, frame.fy, frame.cx,
                                          frame.cy, H, W)
        rgb = (np.clip(o["rgb"], 0, 1) * 255).astype(np.uint8)
        mm = np.minimum((1000.0 * o["depth"]).astype(np.uint32), 65535)
        assert np.array_equal(read_png(pose_dir / "rgb" / f"frame_{i:05d}.png"), rgb), i
        got = read_png(pose_dir / "depth" / f"depth_{i:05d}.png")
        assert got.dtype == np.uint16 and np.array_equal(got, mm), i
    write_ms = {}
    for name, fn, arr in (("rgb", render_cli._save_rgb, o["rgb"]),
                          ("depth", render_cli._save_depth_mm, o["depth"])):
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(out / f"w_{name}.png", arr)
            t.append((time.perf_counter() - t0) * 1e3)
        write_ms[name] = statistics.median(t)
    print(f"gs-render pose: {len(train)} views in {pose_s:.2f} s, launches "
          f"{launches}; every rgb and depth PNG equals the Renderer's output "
          f"quantized alike; PNG write {W}x{H} (host): {write_ms} ms")

    fov = math.degrees(2.0 * math.atan(0.5 * H / train[0].fy))
    path = {"camera_path": [
        {"camera_to_world": np.vstack([f.c2w, [0, 0, 0, 1]]).ravel().tolist(),
         "fov": fov} for f in train[:TRAJ_POSES]]}
    (out / "path.json").write_text(json.dumps(path))
    bands = renderer._raster_for(TRAJ_H, TRAJ_W).bands
    assert bands == TRAJ_BANDS, f"{bands} bands at {TRAJ_W}x{TRAJ_H}"
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    render_cli.main(["trajectory", "--trajectory-path", str(out / "path.json"),
                     "--load-config", cfg, "--num-frames-target", str(TRAJ_POSES)])
    torch.cuda.synchronize()
    traj_s = time.perf_counter() - t0
    traj_launches = launches_of(counters)
    assert all(v == TRAJ_BANDS * TRAJ_POSES for v in traj_launches.values()), (
        traj_launches)
    assert len(list((run_dir / "render" / "rgb").glob("*.png"))) == TRAJ_POSES

    fy = 0.5 * TRAJ_H / math.tan(math.radians(fov) / 2)
    args = lambda f: (np.vstack([f.c2w, [0, 0, 0, 1]]), fy, fy, TRAJ_W / 2,
                      TRAJ_H / 2, TRAJ_H, TRAJ_W)
    renderer.get_output_from_pose(*args(train[0]))  # warm-up
    frame_ms = []
    for f in train[:TRAJ_POSES]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.get_output_from_pose(*args(f))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    per_band = record_bands(lambda: renderer.get_output_from_pose(*args(train[0])))
    rows = -(-((TRAJ_H + 15) // 16) // TRAJ_BANDS)
    tiles_x = (TRAJ_W + 15) // 16
    assert [b["tiles"] for b in per_band] == [
        tiles_x * min(rows, (TRAJ_H + 15) // 16 - b * rows) for b in range(TRAJ_BANDS)]
    for b in per_band:
        assert b["ordered"] and 0 < b["num_intersects"] <= b["capacity"], b
        assert b["last_end"] == b["num_intersects"], b
    got = renderer.get_output_from_pose(*args(train[0]))
    plain = Renderer(run_dir / "ckpts", model_config=config.model, device=DEVICE,
                     raster_config=RasterizeConfig(
                         isect_capacity=renderer.raster_config.isect_capacity,
                         bands=0, backend="plain", forward_only=True))
    want = plain.get_output_from_pose(*args(train[0]))
    errs = {}
    for k in ("rgb", "depth", "accumulation"):
        assert_close(f"trajectory frame {k}", torch.from_numpy(got[k]),
                     torch.from_numpy(want[k]), **PARITY, max_outside=1e-3)
        errs[k] = float(np.abs(got[k] - want[k]).max())
    traced = trace("trajectory frame (1920x1080, 4 bands)",
                   lambda: renderer.get_output_from_pose(*args(train[0])), top=8)
    print(f"gs-render trajectory: {TRAJ_POSES} frames at {TRAJ_W}x{TRAJ_H} in "
          f"{traj_s:.2f} s, launches {traj_launches} ({TRAJ_BANDS} bands); "
          f"{[round(x, 3) for x in frame_ms]} ms a frame (Renderer, "
          f"synchronized); intersections per band of frame 0 "
          f"{[b['num_intersects'] for b in per_band]} of capacity "
          f"{per_band[0]['capacity']}; frame 0 vs plain twins max abs err {errs}")
    return {"render": {
        "pose_views": len(train), "pose_launches": launches, "pose_s": pose_s,
        "png_write_ms": write_ms, "trajectory_frames": TRAJ_POSES,
        "trajectory_launches": traj_launches,
        "trajectory_launches_per_frame": {k: v / TRAJ_POSES
                                          for k, v in traj_launches.items()},
        "bands": TRAJ_BANDS, "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_min": min(frame_ms), "band_intersects": per_band,
        "frame_vs_plain_max_err": errs, "traced_frame": traced}}


def export_check(run_dir: Path, out: Path) -> dict:
    """gs-export's four commands; the splat PLY byte for byte the CPU's,
    offline-tsdf at its defaults with both meshers, masking and cleanup;
    then the fused volume on the card against the CPU on the same frames,
    and the integration, Poisson and marching-tetrahedra times."""
    cfg = str(run_dir / "config.yml")
    exp = out / "export"
    seconds = {}

    def run(name, *argv):
        t0 = time.perf_counter()
        export_cli.main([*argv, "--load-config", cfg, "--output-dir", str(exp / name)])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    run("card", "gaussian-splat")
    run("cpu", "gaussian-splat", "--device", "cpu")
    ply = (exp / "card" / "gaussians.ply").read_bytes()
    assert ply == (exp / "cpu" / "gaussians.ply").read_bytes(), "splat PLYs differ"
    run("poses", "camera-poses")
    n_poses = [len(json.loads((exp / "poses" / f"{s}_poses.json").read_text()))
               for s in ("train", "eval")]
    assert n_poses == [SYN_VIEWS - SYN_VIEWS // 8, SYN_VIEWS // 8], n_poses
    run("cloud", "point-cloud")
    n_points = len(read_ply(exp / "cloud" / "point_cloud.ply")["vertex"])
    assert n_points > 0
    run("tetra", "offline-tsdf")
    run("poisson", "offline-tsdf", "--meshing", "poisson", "--clean",
        "--mask-method", "threshold")
    meshes = {}
    for name in ("tetra", "poisson"):
        mesh = read_ply(exp / name / "tsdf_mesh.ply")
        meshes[name] = [len(mesh["vertex"]), len(mesh["face"])]
        assert min(meshes[name]) > 0, f"empty {name} mesh"
    print(f"gs-export: splat PLY {len(ply)} B, equal to --device cpu's; poses "
          f"{n_poses}; {n_points} cloud points; meshes (vertices, faces) "
          f"{meshes}; seconds {{{', '.join(f'{k}: {v:.2f}' for k, v in seconds.items())}}}")

    config = load_config(run_dir / "config.yml")
    frames = FullImageDatamanager(config.dataparser, seed=config.seed).train_frames
    renderer = Renderer(run_dir / "ckpts", model_config=config.model, device=DEVICE)
    depths, colors, intr, w2cs = export_cli.fusion_inputs(renderer, frames)
    inputs = (np.stack(depths), np.stack(colors), np.asarray(intr, np.float32),
              np.stack(w2cs))
    box = ((-TSDF_SIZE / 2,) * 3, (TSDF_SIZE,) * 3, TSDF_VOXEL)
    integrate_frames(make_volume(*box, device=DEVICE),
                     *(x[:1] for x in inputs), TSDF_TRUNC)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = integrate_frames(make_volume(*box, device=DEVICE), *inputs, TSDF_TRUNC)
    torch.cuda.synchronize()
    integrate_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    ref = integrate_frames(make_volume(*box, device="cpu"), *inputs, TSDF_TRUNC)
    cpu_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    outside = torch.zeros(ref.tsdf.shape, dtype=torch.bool)
    err = {}
    for k in ("tsdf", "colors"):
        diff = (getattr(vol, k).cpu() - getattr(ref, k)).abs()
        bad = diff > TSDF_ATOL
        outside |= bad if bad.ndim == 3 else bad.any(-1)
        err[k] = float(diff.max())
    share = float(outside.float().mean())
    observed = int((ref.weights > 0).sum())
    print(f"TSDF {tuple(ref.tsdf.shape)} from {len(frames)} frames: integrate "
          f"{integrate_ms:.3f} ms a frame on the card (synchronized), "
          f"{cpu_ms:.1f} on the CPU; {observed} voxels observed; card vs CPU: "
          f"{int(outside.sum())} voxels ({share:.2e}) outside atol {TSDF_ATOL}, "
          f"max abs err {err}")
    assert share <= TSDF_OUTSIDE, "the card's TSDF volume differs from the CPU's"
    assert torch.equal(vol.weights.cpu()[~outside], ref.weights[~outside]), (
        "weights differ outside the flipped voxels")
    assert observed > 0 and float(ref.weights.max()) > 1
    tsdf, weights = vol.tsdf.cpu().numpy(), vol.weights.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poisson_indicator(tsdf, np.minimum(weights, 1.0), iters=POISSON_ITERS,
                      device=DEVICE)
    poisson_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    verts, faces, _ = marching_tetrahedra(tsdf, weights, vol.colors.cpu().numpy(),
                                          origin=vol.origin.cpu().numpy(),
                                          voxel_size=TSDF_VOXEL)
    mt_s = time.perf_counter() - t0
    print(f"poisson_indicator {POISSON_ITERS} iterations {poisson_ms:.1f} ms "
          f"(card, with the host copies); marching_tetrahedra {mt_s:.2f} s "
          f"(host), {len(verts)} vertices, {len(faces)} faces")
    return {"export": {"seconds": seconds, "splat_ply_bytes": len(ply),
                       "cloud_points": n_points, "meshes": meshes,
                       "tsdf_dims": list(ref.tsdf.shape), "frames": len(frames),
                       "integrate_ms_per_frame": integrate_ms,
                       "integrate_cpu_ms_per_frame": cpu_ms,
                       "voxels_observed": observed,
                       "voxels_outside": int(outside.sum()),
                       "card_vs_cpu_max_err": err, "poisson_ms": poisson_ms,
                       "marching_tetrahedra_s": mt_s}}


def kept_warp_entries(fwd_args) -> dict:
    """By warp size (32 and 64 consecutive pixels of a tile, 2 and 4 rows):
    the (tile, warp, entry) triples in which at least one of the warp's
    pixels keeps the entry, from the plain walk's keep mask. K2's warps hold
    64 pixels, so the 64 count is the warp reductions it runs."""
    xys, conics, opacities, _, gids, bins, tiles = fwd_args
    total = {32: 0, 64: 0}
    for c in _walk(xys, conics, opacities, gids, bins, tiles, 16, 32):
        t, p, k = c.keep.shape
        for px in total:
            total[px] += int(c.keep.view(t, p // px, px, k).any(2).sum())
    return total


def step_cotangents(acc, final_t, tiles, gt, scene, model_cfg):
    """The cotangents of the train step's loss at K1's outputs: the rest of
    ``render_scene`` (black background, ``min(rgb, 1)``) and ``rgb_loss``
    on top of ``acc`` and ``final_t``, differentiated by autograd."""
    acc = acc.detach().requires_grad_()
    final_t = final_t.detach().requires_grad_()
    img = _tiles_to_image(acc, tiles, 16, H, W)[..., :3]
    rgb = torch.minimum(img, torch.ones_like(img))
    loss = sum(rgb_loss(rgb, gt, scene, model_cfg).values())
    # final_t reaches this loss only through the black background: its
    # cotangent is zero (phase 9 also checks a random one)
    g_acc, _ = torch.autograd.grad(loss, [acc, final_t], allow_unused=True)
    return g_acc, torch.zeros_like(final_t)


def compare_steps(metrics, metrics_p, before, got, want, optim_cfg, step=0):
    """The kernel step against the plain step from the same state at
    ``step``, with the CPU step test's tolerances: loss rtol 1e-4; first
    moments and sqrt of second moments at the gradient tolerance;
    parameter updates at rtol 5e-3 where |mu| > 1e-3 max|mu| and within 2
    lr (the step's) elsewhere; at most 0.5% of a group outside."""
    for k in ("loss", "main_loss", "psnr"):
        a, b = float(metrics[k]), float(metrics_p[k])
        assert math.isclose(a, b, rel_tol=1e-4), f"{k}: {a} vs plain {b}"
    worst = {}

    def outside(name, x, y, rtol, atol):
        bad = ~np.isclose(x, y, rtol=rtol, atol=atol)
        worst[name] = int(bad.sum())
        assert bad.mean() <= MAX_OUTSIDE, (
            f"train step {name}: {int(bad.sum())} of {bad.size} outside"
        )

    for g in ("means", "scales", "quats", "features_dc", "features_rest",
              "opacities"):
        mu_key, nu_key = f".adam/.mu/['{g}']", f".adam/.nu/['{g}']"
        mu_p = want[mu_key]
        scale = 1e-4 * max(float(np.abs(mu_p).max()), 1e-30)
        outside(f"mu {g}", got[mu_key], mu_p, RTOL_GRAD, scale)
        sq_p = np.sqrt(want[nu_key])
        outside(f"sqrt nu {g}", np.sqrt(got[nu_key]), sq_p, RTOL_GRAD,
                1e-4 * max(float(sq_p.max()), 1e-30))
        d_k = got[f".scene/.{g}"] - before[f".scene/.{g}"]
        d_p = want[f".scene/.{g}"] - before[f".scene/.{g}"]
        strong = np.abs(mu_p) > 1e-3 * np.abs(mu_p).max()
        lr = float(optim_cfg.schedule_for(g)(torch.tensor(step)))
        bad = np.where(strong, ~np.isclose(d_k, d_p, rtol=RTOL_GRAD, atol=0.0),
                       np.abs(d_k - d_p) > 2.0 * lr + 1e-7)
        worst[f"update {g}"] = int(bad.sum())
        assert bad.mean() <= MAX_OUTSIDE, f"train step update {g}"
    norm_p = want[".refine/.xys_grad_norm"]
    outside("xys_grad_norm", got[".refine/.xys_grad_norm"], norm_p, RTOL_GRAD,
            1e-4 * float(norm_p.max()))
    for k in ("vis_counts", "max_2dsize"):
        outside(k, got[f".refine/.{k}"], want[f".refine/.{k}"], 1e-6, 0.0)
    print(f"kernel step vs plain step: loss {float(metrics['loss']):.6f} vs "
          f"{float(metrics_p['loss']):.6f}; entries outside tolerance {worst}")


def trace(label, fn, top: int = 8, show: tuple = ()) -> dict:
    """One call of ``fn`` under torch.profiler (a separate, traced run): wall
    time, device busy time (the sum over device-side events, kernels and
    copies; one stream, so they do not overlap), the device's idle share,
    the device events that take most time and those whose name holds one
    of ``show``; printed, and returned with the ``top`` events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # CPU ops also report the device time of what they launched: count
    # only the device-side events, or every kernel is counted twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_events = sum(e.count for e in events)
    print(f"traced {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"device idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{n_events} device events")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):
        if i < top or any(s in e.key for s in show):
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x  {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "device_events": n_events,
            "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                    for e in ranked[:top]]}


if __name__ == "__main__":
    sys.exit(main())
