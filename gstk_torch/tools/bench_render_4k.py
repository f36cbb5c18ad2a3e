"""The 4K banded render (port of ``tools/bench_render_4k.py``): 3840x2160,
300k Gaussians from ``default_rng(3)`` with their scales x 0.08, RGB and
depth in one pass, ``bands=0`` (one band per ~640k pixels: 13 bands) with
an intersection buffer of 2^20 a band.

It renders the point twice on the device: as the reference does
(:func:`gstk_torch.ops.projection.project_gaussians` with the scene's own
matrices, then a forward-only :func:`gstk_torch.ops.rasterize.rasterize`),
and through :class:`gstk_torch.render.renderer.Renderer` from a checkpoint
of the same scene (SH degree 0, camera at the origin looking down +z).
It prints the total intersections (the 3-sigma tile squares, as the
reference counts them), each band's intersection count and the largest,
whether a band truncated, K1 / K3 launches a frame, and the ms of a frame
on the device (CUDA events; ``Renderer.render`` keeps the result there)
and with the numpy copy (``Renderer.get_output_from_pose``, host clock),
median and min over ``--iters`` after warm-up, beside the card's name and
power limit.

The scene builders are the port's copy of ``tests/_scenes.py``'s.

Usage (on the card):
  python -m gstk_torch.tools.bench_render_4k [--iters 20] [--out result.json]
CPU rehearsal at a small size (the plain twins, no timing):
  python -m gstk_torch.tools.bench_render_4k --device cpu --gaussians 3000
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from gstk_torch import resolve_device
from gstk_torch.core.gaussians import scene_from_numpy
from gstk_torch.ops import raster_cuda, segment_kernel
from gstk_torch.ops.projection import project_gaussians
from gstk_torch.ops.rasterize import (
    RasterizeConfig,
    band_rows,
    footprints,
    rasterize,
    tile_counts,
)
from gstk_torch.ops.sh import SH_C0
from gstk_torch.render.renderer import Renderer
from gstk_torch.train.checkpoint import save_scene

W, H = 3840, 2160
N_GAUSSIANS = 300_000
SEED = 3
SCALE = 0.08
ISECT_CAPACITY = 1 << 20
# the 4K frame's RGB + depth, forward only, bands from the pixel count
CONFIG = RasterizeConfig(isect_capacity=ISECT_CAPACITY, bands=0,
                         forward_only=True)
# the camera at the origin looking down +z (OpenCV), as an OpenGL c2w
C2W = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def make_camera(img_w: int = 64, img_h: int = 48, fov_deg: float = 60.0
                ) -> Dict:
    """A camera at the origin looking down +z: intrinsics, ``viewmat``,
    ``projmat`` and ``fullmat`` (float32)."""
    fx = 0.5 * img_w / np.tan(0.5 * np.deg2rad(fov_deg))
    fy = fx
    cx, cy = img_w / 2.0, img_h / 2.0
    viewmat = np.eye(4, dtype=np.float32)
    tan_fovx = 0.5 * img_w / fx
    tan_fovy = 0.5 * img_h / fy
    near, far = 0.001, 1000.0
    projmat = np.array(
        [
            [1.0 / tan_fovx, 0, 0, 0],
            [0, 1.0 / tan_fovy, 0, 0],
            [0, 0, (far + near) / (far - near), -far * near / (far - near)],
            [0, 0, 1.0, 0],
        ],
        np.float32,
    )
    return dict(fx=fx, fy=fy, cx=cx, cy=cy, img_w=img_w, img_h=img_h,
                viewmat=viewmat, projmat=projmat, fullmat=projmat @ viewmat)


def make_gaussians(rng, n: int = 300, depth_range=(2.0, 8.0),
                   spread: float = 3.0):
    """``n`` random Gaussians in front of :func:`make_camera`: means,
    linear scales, unit wxyz quaternions, RGB colours, opacities."""
    means = np.stack(
        [
            rng.uniform(-spread, spread, n),
            rng.uniform(-spread * 0.75, spread * 0.75, n),
            rng.uniform(*depth_range, n),
        ],
        axis=-1,
    ).astype(np.float32)
    scales = np.exp(rng.uniform(-2.5, -0.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacities = rng.uniform(0.2, 0.95, n).astype(np.float32)
    return means, scales, quats, colors, opacities


def scene_arrays(n: int = N_GAUSSIANS, width: int = W, height: int = H):
    """The benchmark's camera and (means, scales, quats, colors,
    opacities) as numpy."""
    rng = np.random.default_rng(SEED)
    cam = make_camera(img_w=width, img_h=height)
    means, scales, quats, colors, opacities = make_gaussians(rng, n)
    return cam, (means, (scales * SCALE).astype(np.float32), quats, colors,
                 opacities)


def project(cam: Dict, arrays, device):
    """The reference's projection of ``arrays`` through ``cam``."""
    means, scales, quats, _, _ = (torch.from_numpy(a).to(device)
                                  for a in arrays)
    return project_gaussians(
        means, scales, 1.0, quats, torch.from_numpy(cam["viewmat"]).to(device),
        torch.from_numpy(cam["fullmat"]).to(device), cam["fx"], cam["fy"],
        cam["cx"], cam["cy"], cam["img_h"], cam["img_w"])


def frame(proj, arrays, cam: Dict, config: RasterizeConfig = CONFIG):
    """One forward-only frame of RGB + depth on a black background:
    ``(img (H, W, 4), alpha, info)``."""
    dev = proj.xys.device
    colors = torch.from_numpy(arrays[3]).to(dev)
    opac = torch.from_numpy(arrays[4]).to(dev)
    with torch.no_grad():
        return rasterize(
            proj.xys, proj.depths, proj.radii, proj.conics, proj.num_tiles_hit,
            torch.cat([colors, proj.depths[:, None]], -1), opac,
            img_height=cam["img_h"], img_width=cam["img_w"],
            background=torch.zeros(4, device=dev), config=config,
            return_info=True)


def band_intersections(proj, arrays, cam: Dict,
                       config: RasterizeConfig = CONFIG) -> List[int]:
    """Each band's intersection count of ``proj``: the tiles of the
    footprints :func:`rasterize` bins, counted without binning."""
    dev = proj.xys.device
    ext, alive = footprints(proj.radii, proj.conics,
                            torch.from_numpy(arrays[4]).to(dev), config)
    bw = config.block_width
    tiles_x = -(-cam["img_w"] // bw)
    return [int(tile_counts(proj.xys - torch.tensor([0.0, float(y0)],
                                                    device=dev),
                            ext, alive, (tiles_x, rows), bw).long().sum())
            for y0, rows, _ in band_rows(cam["img_h"], cam["img_w"], config)]


def write_checkpoint(arrays, path: Path) -> Path:
    """The scene as a gstk_tpu-layout checkpoint at SH degree 0 (its DC
    term gives the colours), for :class:`Renderer`."""
    means, scales, quats, colors, opacities = arrays
    n = means.shape[0]
    scene = scene_from_numpy({
        "means": means, "scales": np.log(scales), "quats": quats,
        "features_dc": ((colors - 0.5) / SH_C0).astype(np.float32),
        "features_rest": np.zeros((n, 15, 3), np.float32),
        "opacities": np.log(opacities / (1.0 - opacities)).astype(
            np.float32)[:, None],
        "alive": np.ones(n, bool)}, device="cpu")
    return save_scene(path, scene, step=0, extras={"sh_degree": 0})


def counted(fn) -> Dict[str, int]:
    """K1 and K3 launches while ``fn`` runs."""
    kernels = (raster_cuda.composite_tiles_fwd, segment_kernel.segment_broadcast)
    for k in kernels:
        k.launches = 0
    fn()
    return {k.__name__: k.launches for k in kernels}


def device_ms(fn, iters: int):
    """CUDA-event ms of each of ``iters`` calls of ``fn``."""
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def host_ms(fn, iters: int):
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def spread(ms) -> Dict[str, float]:
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "samples": len(ms)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("bench_render_4k")
    ap.add_argument("--gaussians", type=int, default=N_GAUSSIANS)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the result JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "twins once, untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    res: Dict = {"width": args.width, "height": args.height,
                 "gaussians": args.gaussians,
                 "isect_capacity": CONFIG.isect_capacity}
    if card:
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        print(res["card"], flush=True)
    cam, arrays = scene_arrays(args.gaussians, args.width, args.height)
    proj = project(cam, arrays, dev)
    out = {}
    res["launches_per_frame"] = counted(
        lambda: out.update(zip(("img", "alpha", "info"),
                               frame(proj, arrays, cam))))
    per_band = [int(x) for x in out["info"]["band_intersects"].cpu()]
    res.update(
        total_intersections=int(proj.num_tiles_hit.long().sum()),
        bands=len(per_band), band_intersections=per_band,
        band_max=max(per_band), band_sum=sum(per_band),
        truncated=any(n > CONFIG.isect_capacity for n in per_band),
        finite=bool(torch.isfinite(out["img"]).all()))
    print(f"{args.width}x{args.height}, {args.gaussians} Gaussians: total "
          f"intersections {res['total_intersections']} (3-sigma squares), "
          f"{res['bands']} bands of {per_band} (sum {res['band_sum']}, max "
          f"{res['band_max']}), truncated {res['truncated']}, launches a "
          f"frame {res['launches_per_frame']}", flush=True)
    assert res["finite"], "non-finite pixels"
    with tempfile.TemporaryDirectory(prefix="bench_render_4k_") as tmp:
        renderer = Renderer(write_checkpoint(arrays, Path(tmp)),
                            background=(0.0, 0.0, 0.0), device=dev)
        pose = (C2W, cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                args.height, args.width)
        rendered = renderer.render(*pose)
        res["renderer_band_intersections"] = [
            int(x) for x in rendered["band_intersects"].cpu()]
        res["renderer_launches_per_frame"] = counted(
            lambda: renderer.render(*pose))
        if card:
            for _ in range(args.warmup):
                frame(proj, arrays, cam)
                renderer.get_output_from_pose(*pose)
            res["frame"] = spread(device_ms(
                lambda: frame(proj, arrays, cam), args.iters))
            res["renderer_frame"] = spread(device_ms(
                lambda: renderer.render(*pose), args.iters))
            res["renderer_numpy"] = spread(host_ms(
                lambda: renderer.get_output_from_pose(*pose), args.iters))
            print(f"frame on the device {res['frame']}; Renderer.render "
                  f"{res['renderer_frame']}; get_output_from_pose (numpy "
                  f"copy) {res['renderer_numpy']}", flush=True)
    print(f"Renderer: bands {res['renderer_band_intersections']}, launches a "
          f"frame {res['renderer_launches_per_frame']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
