"""The scenes the reference's benchmark tools build, each in one place.

* :func:`bench_point`: ``bench.py:110-162``'s training point (and
  ``tools/profile_step.py``'s, ``tools/bench_render.py``'s): ``n`` uniform
  points in front of an identity camera (fx = fy = 1111) in ``capacity``
  lanes, tight log-scales in [-4.5, -2.5], opacities in [0.3, 0.9], SH
  degree 3, a uniform gt image, ``RasterizeConfig(chunk_size=32,
  isect_capacity=...)``. The sizes default to the ``BENCH_RES``,
  ``BENCH_N``, ``BENCH_CAP`` and ``BENCH_ISECT`` variables the reference
  reads, then to bench.py's values (800, 100,000, 104·1024, 3<<18). The
  numpy draws come from ``default_rng(0)`` in bench.py's order (points,
  rgb, log-scales, opacities, then the gt image). gstk_tpu's
  ``init_scene`` draws the quaternions from ``jax.random.PRNGKey(0)``,
  which a module without JAX cannot reproduce, so they come from a seed-0
  ``torch.Generator`` (the port's ``init_scene``); the DC colours follow
  from the rgb draw in both. The tests carry gstk_tpu's own scene across
  to hold the port's step at this point against gstk_tpu's.
  ``chip_smoke.bench_scene`` draws everything from a torch generator
  instead, so its scene has the same distribution and other values.
* :func:`kernels_scene`: ``tools/bench_kernels.py:160-200``'s numpy scene,
  bit for bit: 100,000 live of 2^17 lanes, points at +z in view space, 4
  channels, an intersection buffer of 2^20, and its projection matrix.
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import (
    GaussianScene,
    init_scene,
    scene_from_numpy,
    scene_to_numpy,
)
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.train.optim import OptimizerConfig
from gstk_torch.train.step import make_train_step

SEED = 0
FOCAL = 1111.0
SH_DEGREE = 3
BENCH_DEFAULTS = {"BENCH_RES": 800, "BENCH_N": 100_000,
                  "BENCH_CAP": 104 * 1024, "BENCH_ISECT": 3 << 18}


def bench_env(name: str, default: int = None) -> int:
    """The reference's ``int(os.environ.get(name, default))``; ``default``
    is bench.py's unless given (profile_step's capacity is 1<<17)."""
    return int(os.environ.get(name, BENCH_DEFAULTS[name] if default is None
                              else default))


class BenchPoint(NamedTuple):
    scene: GaussianScene
    camera: Camera
    gt: torch.Tensor  # (res, res, 3) in [0, 1]
    raster: RasterizeConfig
    res: int
    n: int
    capacity: int


def bench_draws(res: int, n: int) -> Dict[str, np.ndarray]:
    """bench.py's numpy draws, in its order."""
    rng = np.random.default_rng(SEED)
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-9.0, -2.0, n)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    log_scales = rng.uniform(-4.5, -2.5, (n, 3)).astype(np.float32)
    op = rng.uniform(0.3, 0.9, n)
    logit_op = np.log(op / (1.0 - op)).astype(np.float32)
    gt = rng.uniform(0, 1, (res, res, 3)).astype(np.float32)
    return {"pts": pts, "rgb": rgb, "log_scales": log_scales,
            "logit_opacities": logit_op, "gt": gt}


def bench_point(res: int = None, n: int = None, capacity: int = None,
                isect_capacity: int = None, device: DeviceLike = None
                ) -> BenchPoint:
    """bench.py's point on ``device`` (cuda unless given); each size
    defaults to its ``BENCH_*`` variable, then to bench.py's value."""
    device = resolve_device(device)
    res = bench_env("BENCH_RES") if res is None else res
    n = bench_env("BENCH_N") if n is None else n
    capacity = bench_env("BENCH_CAP") if capacity is None else capacity
    isect_capacity = (bench_env("BENCH_ISECT") if isect_capacity is None
                      else isect_capacity)
    d = bench_draws(res, n)
    arrays = scene_to_numpy(init_scene(
        torch.Generator().manual_seed(SEED), capacity, (d["pts"], d["rgb"]),
        sh_degree=SH_DEGREE, device="cpu"))
    arrays["scales"][:n] = d["log_scales"]
    arrays["opacities"][:n, 0] = d["logit_opacities"]
    camera = Camera.create(FOCAL, FOCAL, res / 2, res / 2,
                           np.eye(4, dtype=np.float32)[:3], device=device)
    return BenchPoint(
        scene=scene_from_numpy(arrays, device), camera=camera,
        gt=torch.from_numpy(d["gt"]).to(device),
        raster=RasterizeConfig(chunk_size=32, isect_capacity=isect_capacity),
        res=res, n=n, capacity=capacity)


def make_step(point: BenchPoint, raster: RasterizeConfig = None):
    """bench.py's train step at ``point`` (black background, the default
    optimizer), with ``raster`` in place of the point's when given."""
    return make_train_step(
        VanillaConfig(sh_degree=SH_DEGREE, background_color="black"),
        point.raster if raster is None else raster, OptimizerConfig(),
        point.res, point.res, sh_degree=SH_DEGREE)


# tools/bench_kernels.py's point
K_RES, K_N, K_CAPACITY, K_ISECT, K_CH = 800, 100_000, 1 << 17, 1 << 20, 4


def kernels_scene(res: int = K_RES) -> Dict[str, np.ndarray]:
    """``tools/bench_kernels.py``'s arrays, bit for bit: ``pts``,
    ``scales`` (linear), ``quats``, ``op`` (0 on dead lanes), ``colors``
    (4 channels), ``alive``, ``viewmat`` and ``fullmat`` (4x4, for a
    ``res`` x ``res`` image; the reference's 800 by default)."""
    img_h = img_w = res
    rng = np.random.default_rng(SEED)
    # camera at the origin looking along +z in view space: the projection
    # culls z <= near, so the points sit at positive view depth
    pts = rng.uniform(-3, 3, (K_CAPACITY, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2.0, 9.0, K_CAPACITY)
    scales = np.exp(rng.uniform(-4.5, -2.5, (K_CAPACITY, 3)).astype(np.float32))
    quats = rng.normal(size=(K_CAPACITY, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    op = rng.uniform(0.3, 0.9, K_CAPACITY).astype(np.float32)
    colors = rng.uniform(0, 1, (K_CAPACITY, K_CH)).astype(np.float32)
    alive = np.arange(K_CAPACITY) < K_N
    op = np.where(alive, op, 0.0).astype(np.float32)
    viewmat = np.eye(4, dtype=np.float32)
    fovx = 2 * math.atan(img_w / (2 * FOCAL))
    fovy = 2 * math.atan(img_h / (2 * FOCAL))
    t = math.tan(fovy / 2) * 0.01
    r = math.tan(fovx / 2) * 0.01
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 0.01 / r
    P[1, 1] = 0.01 / t
    P[2, 2] = (1000.01) / (1000 - 0.01)
    P[2, 3] = -2 * 1000 * 0.01 / (1000 - 0.01)
    P[3, 2] = 1.0
    return {"pts": pts, "scales": scales, "quats": quats, "op": op,
            "colors": colors, "alive": alive, "viewmat": viewmat,
            "fullmat": P @ viewmat}
