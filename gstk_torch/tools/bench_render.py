"""Forward-only render throughput at bench.py's point (port of
``tools/bench_render.py``): projection, binning and the fused RGB + depth
compositing, no backward or Adam.

The point is :func:`gstk_torch.tools.bench_point.bench_point` (100,000
Gaussians in 104·1024 lanes, 800x800, ``isect_capacity`` 3<<18), rendered
with ``forward_only=True``. The reference's tool fills all 106,496 lanes
with points; this one keeps bench.py's 100,000 so that its frame is the
train step's. The reference's loop over ``kernel_precision`` and
``attr_layout`` (TPU-only knobs the port ignores) and its per-frame
camera jiggle (against a TPU runtime that merged identical dispatches)
are not carried over.

It prints the ms of a frame on the device (CUDA events) and frames a
second from it, and the host-clock ms of a frame, synchronized, with and
without the numpy copy of its rgb, depth and alpha (as
``Renderer.get_output_from_pose`` returns them), median and min over
``--iters`` after warm-up, beside the card's name and power limit.

Usage (on the card):
  python -m gstk_torch.tools.bench_render [--iters 100]
CPU rehearsal (one frame, untimed):
  python -m gstk_torch.tools.bench_render --device cpu --res 64 --n 2000 \\
      --capacity 2048 --isect 16384
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict

import torch

from gstk_torch import resolve_device
from gstk_torch.models.vanilla import VanillaConfig, render_scene
from gstk_torch.tools import (
    card,
    event_samples,
    host_samples,
    launches_during,
    spread,
)
from gstk_torch.tools.bench_point import SH_DEGREE, BenchPoint, bench_point


def render_fn(point: BenchPoint, config=None):
    """The forward-only render of ``point`` (its raster config with
    ``forward_only`` unless ``config`` is given)."""
    config = config or dataclasses.replace(point.raster, forward_only=True)
    background = torch.zeros(3, device=point.gt.device)

    def render():
        with torch.no_grad():
            return render_scene(point.scene, point.camera, point.res,
                                point.res, sh_degree=SH_DEGREE,
                                background=background,
                                config=VanillaConfig(sh_degree=SH_DEGREE),
                                raster_config=config)
    return render


def to_numpy(out: Dict) -> Dict:
    return {k: out[k].cpu().numpy() for k in ("rgb", "depth", "alpha")}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("bench_render")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--isect", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu renders once, "
                         "untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    point = bench_point(args.res, args.n, args.capacity, args.isect, dev)
    render = render_fn(point)
    res: Dict = {"res": point.res, "n": point.n, "capacity": point.capacity,
                 "isect_capacity": point.raster.isect_capacity}
    if dev.type == "cuda":
        res["card"] = card()
        print(res["card"], flush=True)
    out = {}
    res["launches_per_frame"] = launches_during(lambda: out.update(render()))
    res["num_intersects"] = int(out["num_intersects"])
    res["finite"] = bool(torch.isfinite(out["rgb"]).all())
    print(f"{point.res}x{point.res}, {point.n} Gaussians in {point.capacity} "
          f"lanes: {res['num_intersects']} intersections of "
          f"{point.raster.isect_capacity}, launches a frame "
          f"{res['launches_per_frame']}", flush=True)
    assert res["finite"], "non-finite pixels"
    if dev.type == "cuda":
        for _ in range(args.warmup):
            to_numpy(render())
        torch.cuda.synchronize()
        res["frame"] = spread(event_samples(render, args.iters))
        res["fps"] = 1e3 / res["frame"]["median_ms"]
        res["rays_per_s"] = point.res * point.res * res["fps"]
        res["host"] = spread(host_samples(render, args.iters))
        res["host_numpy"] = spread(host_samples(lambda: to_numpy(render()),
                                                args.iters))
        print(f"render-only: {res['frame']['median_ms']:.3f} ms a frame on "
              f"the device (min {res['frame']['min_ms']:.3f}) = "
              f"{res['fps']:.1f} fps = {res['rays_per_s'] / 1e6:.1f}M rays/s; "
              f"host clock {res['host']['median_ms']:.3f} ms, with the numpy "
              f"copy {res['host_numpy']['median_ms']:.3f} ms", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
