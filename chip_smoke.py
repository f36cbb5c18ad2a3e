"""Drive gstk_torch's render path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero before the last
line:
  1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off;
  2. build: compile the CUDA kernels (``gstk_torch/csrc``) for sm_90a and
     print nvcc's register / shared-memory / spill report;
  3. scene: the render scene of ``bench.py`` (100k Gaussians, capacity
     104*1024, SH degree 3, 800x800, fx = fy = 1111) from a torch
     generator, written as a gstk_tpu-layout checkpoint;
  4. kernel K3 (segment broadcast) against its plain twin on the scene's
     tile-count cumsum, 1 and 3 columns, length 2**20, and edge cases:
     exact equality;
  5. kernel K1 (tile compositing) against its plain twin on the scene's
     intersections at ch = 4: rtol 1e-3 / atol 1e-4;
  6. main path: ``Renderer(checkpoint, device="cuda")`` answers 8 requests
     (the bench camera and 7 pose offsets) with the launch counters reset
     just before; request 0 is compared with the same render through the
     plain twins on the card;
  7. kernel timings (CUDA events; kernel device time from torch.profiler)
     beside the plain twins, the library call where one exists and the
     bound from this run's bytes and operations; one ``kernels`` JSON line.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gstk_torch import _build
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import init_scene, scene_from_numpy, scene_to_numpy
from gstk_torch.models.vanilla import VanillaConfig, splat_inputs
from gstk_torch.ops.binning import bin_gaussians
from gstk_torch.ops.projection import tight_extents, tile_bbox
from gstk_torch.ops.raster_cuda import composite_tiles_fwd, composite_tiles_fwd_plain
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.ops.segment_kernel import segment_broadcast, segment_broadcast_plain
from gstk_torch.render.renderer import Renderer
from gstk_torch.train.checkpoint import save_scene

SEED = 0
N_POINTS, CAPACITY, SH_DEGREE = 100_000, 104 * 1024, 3
H = W = 800
FOCAL = 1111.0
REQUESTS = 8
DEVICE = "cuda"
PARITY = dict(rtol=1e-3, atol=1e-4)  # gstk_tpu's image parity tolerances
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
K1_FLOP_PER_PAIR = 21  # ~20 FLOP + 1 exp per (pixel, entry) pair evaluated


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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


def assert_close(name, got, want, **tol):
    ok = torch.isclose(got, want, **tol)
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise AssertionError(
            f"{name}: {bad} of {ok.numel()} values outside {tol}, max abs "
            f"err {float((got - want).abs().max())}"
        )


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


def kernel_device_ms(fn, kernel_name: str, iters: int):
    """Mean device ms of the CUDA kernel named ``kernel_name`` per call of
    ``fn``, from torch.profiler; None when the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if kernel_name in e.key
    )
    return us / 1e3 / iters if us > 0 else None


def trace_request(renderer, request_args, top: int = 8) -> None:
    """One request under torch.profiler (a separate, traced run): wall
    time, device busy time (the sum over device-side events, kernels and
    copies; one stream, so they do not overlap), the device's idle share,
    and the device events that take most time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.get_output_from_pose(*request_args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # CPU ops also report the device time of what they launched: count
    # only the device-side events, or every kernel is counted twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"traced request: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"device idle share {1 - busy_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x  {e.key[:90]}")


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
              f"boundaries up to {int(b.max())}")

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

    phase("6 main path: Renderer, 8 requests")
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
    trace_request(renderer, args(0))

    phase("7 kernel timings")
    iters = 20
    length = raster.isect_capacity
    j = torch.arange(length, dtype=torch.int32, device=dev)
    k3_in = (torch.clamp(cum, max=length), [ones], length)
    k3 = {
        "ms": kernel_device_ms(lambda: segment_broadcast(*k3_in),
                               "segment_broadcast_kernel", iters),
        "wrapper_ms": event_ms(lambda: segment_broadcast(*k3_in), iters),
        "plain_ms": event_ms(lambda: segment_broadcast_plain(*k3_in), iters),
        # with d = 1 the function is #{i: b[i] <= j}: one searchsorted
        "library_ms": event_ms(lambda: torch.searchsorted(k3_in[0], j, right=True), iters),
    }
    k3_bytes = 4 * CAPACITY * 2 + 4 * length  # b and d read, one column written
    k3_ops = length * math.ceil(math.log2(CAPACITY)) * 4  # search steps
    k1 = {
        "ms": kernel_device_ms(lambda: composite_tiles_fwd(*k1_args),
                               "composite_fwd_kernel", iters),
        "wrapper_ms": event_ms(lambda: composite_tiles_fwd(*k1_args), iters),
        "plain_ms": event_ms(lambda: composite_tiles_fwd_plain(*k1_args), 3),
        "library_ms": None,  # no single PyTorch call composites tiles
    }
    ch = inputs["colors"].shape[1]
    num_tiles = tiles[0] * tiles[1]
    k1_bytes = (n_isect * (4 + 4 * (6 + ch)) + num_tiles * 8
                + num_tiles * 256 * (ch + 1) * 4)
    k1_ops = pairs * K1_FLOP_PER_PAIR
    kernels = []
    for name, t, nbytes, ops, src, replaces, err in (
        ("segment_broadcast", k3, k3_bytes, k3_ops,
         "gstk_torch/csrc/segment_broadcast.cu",
         "gstk_tpu/ops/segment_kernel.py:57", 0.0),
        ("composite_tiles_fwd", k1, k1_bytes, k1_ops,
         "gstk_torch/csrc/composite_fwd.cu",
         "gstk_tpu/ops/raster_pallas.py:409", k1_err),
    ):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOP_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err, "max_err": err,
            "ms": t["ms"] if t["ms"] is not None else t["wrapper_ms"],
            "ms_source": "profiler" if t["ms"] is not None else "events",
            "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops,
            "library_ms": t["library_ms"],
        })
        print(f"{name}: {kernels[-1]}")
    print(json.dumps({"kernels": kernels, "request_ms_median": statistics.median(ms),
                      "request_ms_min": min(ms), "power": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
