"""The inputs of a cell, made from ``--seed`` on the device: the capture's
poses and train targets, and a late-stage Gaussian scene.

Both sides read only what this module makes: the program gets these
tensors through its own entry points, and the plain reference
(:mod:`gsbench.reference`) is handed the same. Nothing here imports the
program.

* **The capture.** The pose layout of the reference's raytraced capture
  (``gstk_torch/data/raytraced.py``: three orbit rings, interleaved, looking
  at (0, -0.4, 0), ``fov_deg`` horizontal), copied, then centred on the
  mean camera position and scaled so that the farthest camera coordinate is
  1, as the dataparser's ``center_method="poses"`` and
  ``auto_scale_poses`` do (its rotation to "up" is left out: it moves no
  work). Views ``i % eval_interval == 0`` are the eval split.
* **The scene.** ``alive`` Gaussians drawn on the surfaces of the
  capture's primitives (a ground disk and eight spheres and boxes, copied
  from ``build_scene``) in ``capacity`` lanes (the dead lanes scattered, as
  culls leave them), with log-normal scales, random rotations, opacities
  skewed high, the surface point's colour under two lights as the SH DC
  term and small higher-order terms: the state of a run past
  densification. Every draw is one call on the device from a
  ``torch.Generator`` seeded by the run's seed.
* **The targets.** Each train view of the capture's own scene (the same
  draw from the configuration's ``capture_seed``, fixed as a dataset is)
  rendered by the plain reference (:mod:`gsbench.reference.splat`) as
  RGBA, its colour unpremultiplied and its alpha the coverage, and
  quantised to uint8, as the capture's files and the trainer's device
  cache hold images; the step composites them over its random
  background. They are rendered on a checkout's first run and cached in
  it.
* **The trained scene** (:func:`trained_scene`). A converged scene
  reproduces its captures, so a train cell trains the capture's own
  scene, its lanes in an order drawn from the run's seed: training sits
  at the loss's minimum and its state stays put over a window. A scene
  drawn apart from its targets is pulled away from its draw (its
  intersections grow toward the buffer's growth trigger), and so are
  Gaussians against targets without alpha, which the random background
  cannot match where coverage is partial. The targets' speckle keeps the
  loss and its gradient at a trained scene's size: at the exact minimum
  each pixel's L1 gradient takes the sign of a quantisation residual,
  which round-off flips.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
# the sources a cached target depends on, beside the configuration
_SOURCES = ("scene.py", "reference/splat.py", "reference/precision.py")

# the capture's primitives (gstk_torch/data/raytraced.py::build_scene), in
# its world units: spheres (centre, radius) and boxes (lo, hi) with an
# albedo each; the ground plane y = GROUND_Y
GROUND_Y = -1.2
GROUND_ALBEDO = (0.55, 0.5, 0.42)
SPHERES = (
    ((0.0, -0.2, 0.0), 1.0, (0.9, 0.85, 0.8)),
    ((1.9, -0.65, 0.9), 0.55, (0.85, 0.2, 0.15)),
    ((-1.8, -0.5, 1.2), 0.7, (0.2, 0.55, 0.9)),
    ((-1.2, -0.85, -1.6), 0.35, (0.15, 0.7, 0.35)),
    ((0.9, -0.9, 2.1), 0.3, (0.4, 0.9, 0.6)),
)
BOXES = (
    ((0.9, -1.2, -2.2), (1.9, -0.2, -1.2), (0.85, 0.5, 0.15)),
    ((-2.6, -1.2, -0.6), (-1.9, 0.1, 0.1), (0.75, 0.3, 0.55)),
    ((-0.5, -1.2, 2.0), (0.3, -0.7, 2.6), (0.2, 0.75, 0.8)),
)
LIGHTS = ((0.45, 1.0, 0.35), (-0.55, 0.55, -0.3))


class Capture(NamedTuple):
    poses: torch.Tensor  # (n_views, 3, 4) OpenGL c2w, centred and scaled
    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int
    train: np.ndarray  # view indices of the train split
    eval: np.ndarray  # view indices of the eval split
    center: np.ndarray  # (3,) world units subtracted before scaling
    scale: float  # world units -> scene units


def _orbit_pose(radius, height, angle, target=(0.0, -0.4, 0.0)) -> np.ndarray:
    """OpenGL c2w looking at ``target`` from an orbit position (copied from
    ``gstk_torch/data/raytraced.py``)."""
    eye = np.array([radius * np.cos(angle), height, radius * np.sin(angle)])
    fwd = np.asarray(target) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def view_pose(i: int, n_views: int) -> np.ndarray:
    """View ``i``'s c2w: three orbit rings, interleaved (copied)."""
    ring = i % 3
    radius = (7.2, 6.2, 5.2)[ring]
    height = (1.2, 2.8, 4.2)[ring]
    angle = 2 * np.pi * i / n_views + 0.21 * ring
    return _orbit_pose(radius, height, angle)


def orbit_pose(angle: float, capture: "Capture") -> np.ndarray:
    """A (3, 4) c2w in scene units on the capture's middle ring at
    ``angle`` radians: the viewer's and gs-render's orbit."""
    c2w = _orbit_pose(6.2, 2.8, angle)[:3].astype(np.float64)
    c2w[:, 3] = (c2w[:, 3] - capture.center) * capture.scale
    return c2w.astype(np.float32)


def capture(cfg: Dict, device) -> Capture:
    """The capture's poses, intrinsics and splits for configuration
    ``cfg``."""
    n = int(cfg["n_views"])
    raw = np.stack([view_pose(i, n) for i in range(n)])[:, :3]
    center = raw[:, :, 3].mean(axis=0)
    poses = raw.copy()
    poses[:, :, 3] -= center
    scale = 1.0 / float(np.abs(poses[:, :, 3]).max())
    poses[:, :, 3] *= scale
    w, h = int(cfg["width"]), int(cfg["height"])
    fx = 0.5 * w / math.tan(math.radians(float(cfg["fov_deg"])) / 2)
    idx = np.arange(n)
    every = int(cfg["eval_interval"])
    return Capture(
        poses=torch.tensor(poses, dtype=torch.float32, device=device),
        fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, height=h, width=w,
        train=idx[idx % every != 0], eval=idx[idx % every == 0],
        center=center, scale=scale,
    )


def _primitive_tables(device):
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    sph_c = f([s[0] for s in SPHERES])
    sph_r = f([s[1] for s in SPHERES])
    sph_a = f([s[2] for s in SPHERES])
    box_lo = f([b[0] for b in BOXES])
    box_hi = f([b[1] for b in BOXES])
    box_a = f([b[2] for b in BOXES])
    return sph_c, sph_r, sph_a, box_lo, box_hi, box_a


def _pattern(p: torch.Tensor) -> torch.Tensor:
    """A flat procedural pattern in [0.7, 1.0] of world points (..., 3): a
    checker of 0.25 world units, then stripes, so that views hold edges."""
    q = torch.floor(p / 0.25).sum(-1)
    checker = torch.remainder(q, 2.0)
    stripes = 0.5 + 0.5 * torch.sin(17.0 * p[..., 0] + 11.0 * p[..., 2])
    return 0.7 + 0.2 * checker + 0.1 * stripes


def _shade(p, normal, albedo) -> torch.Tensor:
    """Two-light Lambert shading with ambient, (..., 3)."""
    light = torch.zeros_like(p[..., :1]) + 0.3
    for d in LIGHTS:
        l = torch.tensor(d, dtype=p.dtype, device=p.device)
        l = l / l.norm()
        light = light + 0.45 * torch.clamp((normal * l).sum(-1, keepdim=True),
                                           min=0.0)
    return torch.clamp(albedo * _pattern(p)[..., None] * light, 0.0, 1.0)


def target(cap: Capture, i: int, params: Dict[str, torch.Tensor],
           noise: float, seed: int) -> torch.Tensor:
    """View ``i``'s target, (H, W, 4) uint8: the plain reference's render of
    the scene ``params``, its colour over no background divided by its
    alpha (0 where nothing covers a pixel) plus, where the alpha is not 0,
    a normal speckle of standard deviation ``noise`` drawn from ``seed``
    and ``i`` (a 1-spp capture's view-incoherent noise, which no scene
    fits), and the alpha."""
    from gsbench.reference import splat
    from gsbench.reference.precision import Arith, strict_f32

    view = splat.View(cap.poses[int(i)], cap.fx, cap.fy, cap.cx, cap.cy,
                      cap.height, cap.width)
    black = torch.zeros(3, device=cap.poses.device)
    with strict_f32():
        out = splat.render(params, view, 3, black, 1, Arith())
    alpha = out["alpha"][..., None]
    rgb = torch.where(alpha > 0, out["rgb"] / torch.clamp(alpha, min=1e-12), 0.0)
    gen = torch.Generator(device=rgb.device)
    gen.manual_seed(int(seed) * 1_000_003 + int(i))
    rgb = rgb + torch.where(alpha > 0, noise * torch.randn(
        rgb.shape, generator=gen, device=rgb.device), 0.0)
    rgba = torch.cat([torch.clamp(rgb, 0.0, 1.0), alpha], -1)
    return torch.round(rgba * 255.0).to(torch.uint8)


def train_targets(cap: Capture, cfg: Dict, cache: Path):
    """The train split's targets, (n_train, H, W, 4) uint8 on the poses'
    device, and the seconds spent making them (0 when they were loaded):
    :func:`target` of every train view of the capture's scene (the scene
    drawn from ``cfg["capture_seed"]``). They are rendered once per
    checkout and kept under ``cache`` (a file named by the configuration's
    content and this generator's sources); later runs load them."""
    key = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for src in _SOURCES:
        key.update((Path(__file__).parent / src).read_bytes())
    path = Path(cache) / f"targets-{key.hexdigest()[:16]}.npy"
    device = cap.poses.device
    if path.is_file():
        return torch.from_numpy(np.load(path)).to(device), 0.0
    t0 = time.perf_counter()
    params = draw_scene(cfg, cap, int(cfg["capture_seed"]), device)
    out = torch.empty((len(cap.train), cap.height, cap.width, 4),
                      dtype=torch.uint8, device=device)
    for j, i in enumerate(cap.train):
        out[j] = target(cap, int(i), params, *target_noise(cfg))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.npy")
    np.save(tmp, out.cpu().numpy())
    os.replace(tmp, path)
    return out, time.perf_counter() - t0


def target_noise(cfg: Dict):
    """The (noise, seed) of :func:`target` for configuration ``cfg``."""
    return float(cfg["scene"]["target_noise"]), int(cfg["capture_seed"])


def trained_scene(cfg: Dict, cap: Capture, seed: int, device) -> Dict[str, torch.Tensor]:
    """The scene a train cell starts from: the capture's own scene (the
    draw from ``cfg["capture_seed"]`` that the targets render), its lanes
    permuted by ``seed``. The same seed gives the same tensors."""
    params = draw_scene(cfg, cap, int(cfg["capture_seed"]), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    perm = torch.randperm(int(cfg["capacity"]), generator=gen, device=device)
    return {k: v[perm] for k, v in params.items()}


def _surface_points(gen, n: int, ground_radius: float, device):
    """``n`` points (world units) and their outward normals and albedos,
    uniform by area over the ground disk of ``ground_radius`` and the
    primitives' surfaces."""
    sph_c, sph_r, sph_a, box_lo, box_hi, box_a = _primitive_tables(device)
    ext = box_hi - box_lo
    face_areas = torch.stack([ext[:, 1] * ext[:, 2], ext[:, 0] * ext[:, 2],
                              ext[:, 0] * ext[:, 1]], -1)  # (B, 3) per axis
    areas = torch.cat([
        torch.tensor([math.pi * ground_radius ** 2], device=device),
        4 * math.pi * sph_r ** 2,
        2 * face_areas.sum(-1),
    ])
    n_sph, n_box = sph_r.shape[0], box_lo.shape[0]
    which = torch.multinomial(areas / areas.sum(), n, replacement=True,
                              generator=gen)
    u = torch.rand((n, 4), generator=gen, device=device)
    z = torch.randn((n, 3), generator=gen, device=device)
    # ground disk
    r = ground_radius * torch.sqrt(u[:, 0])
    phi = 2 * math.pi * u[:, 1]
    p = torch.stack([r * torch.cos(phi), torch.full_like(r, GROUND_Y),
                     r * torch.sin(phi)], -1)
    nrm = torch.tensor([0.0, 1.0, 0.0], device=device).expand(n, 3)
    alb = torch.tensor(GROUND_ALBEDO, device=device).expand(n, 3)
    # spheres
    k = torch.clamp(which - 1, 0, n_sph - 1)
    dirs = z / torch.clamp(z.norm(dim=-1, keepdim=True), min=1e-12)
    on_sph = (which >= 1) & (which <= n_sph)
    p = torch.where(on_sph[:, None], sph_c[k] + sph_r[k, None] * dirs, p)
    nrm = torch.where(on_sph[:, None], dirs, nrm)
    alb = torch.where(on_sph[:, None], sph_a[k], alb)
    # boxes: a face by area, uniform on it
    b = torch.clamp(which - 1 - n_sph, 0, n_box - 1)
    on_box = which > n_sph
    fa = face_areas[b]
    axis = torch.multinomial(fa / fa.sum(-1, keepdim=True), 1,
                             generator=gen)[:, 0]
    side = (u[:, 2] < 0.5).to(torch.float32)
    q = box_lo[b] + u[:, 1:4] * ext[b]
    onehot = torch.nn.functional.one_hot(axis, 3).to(torch.float32)
    face = box_lo[b] + side[:, None] * ext[b]
    q = torch.where(onehot.bool(), face, q)
    p = torch.where(on_box[:, None], q, p)
    nrm = torch.where(on_box[:, None], onehot * (2 * side[:, None] - 1), nrm)
    alb = torch.where(on_box[:, None], box_a[b], alb)
    return p, nrm, alb


def draw_scene(cfg: Dict, cap: Capture, seed: int, device) -> Dict[str, torch.Tensor]:
    """The scene's lanes as plain tensors on ``device``: ``means (C, 3)``,
    ``scales (C, 3)`` log, ``quats (C, 4)`` wxyz, ``features_dc (C, 3)``,
    ``features_rest (C, K - 1, 3)``, ``opacities (C, 1)`` logits and
    ``alive (C,)``, with ``cfg["alive"]`` of ``cfg["capacity"]`` lanes
    alive. The same seed gives the same tensors."""
    s = cfg["scene"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    c, n = int(cfg["capacity"]), int(cfg["alive"])
    k = (int(cfg["sh_degree"]) + 1) ** 2
    p, nrm, alb = _surface_points(gen, n, float(s["ground_radius"]), device)
    p = p + nrm * (float(s["thickness"]) * torch.randn(
        (n, 1), generator=gen, device=device))
    log_s = (math.log(float(s["scale"])) + float(s["scale_log_std"])
             * torch.randn((n, 3), generator=gen, device=device))
    log_s[:, 2] += math.log(float(s["flatness"]))
    quats = torch.randn((n, 4), generator=gen, device=device)
    quats = quats / torch.clamp(quats.norm(dim=-1, keepdim=True), min=1e-12)
    u = torch.rand((n, 1), generator=gen, device=device)
    op_lo, op_hi = float(s["opacity_min"]), float(s["opacity_max"])
    op = op_lo + (op_hi - op_lo) * torch.sqrt(u)
    # the capture's shaded colour at the surface point, as a trained scene
    # holds it
    rgb = _shade(p, nrm, alb)
    rest = float(s["sh_rest_std"]) * torch.randn(
        (n, k - 1, 3), generator=gen, device=device)
    lanes = torch.randperm(c, generator=gen, device=device)[:n]
    center = torch.tensor(cap.center, dtype=torch.float32, device=device)

    def put(rows, fill=0.0):
        out = torch.full((c,) + rows.shape[1:], fill, dtype=torch.float32,
                         device=device)
        out[lanes] = rows
        return out

    quats_all = put(quats)
    quats_all[:, 0] += (~put(torch.ones(n, device=device)).bool()).float()
    alive = torch.zeros(c, dtype=torch.bool, device=device)
    alive[lanes] = True
    return {
        "means": put((p - center) * cap.scale),
        "scales": put(log_s + math.log(cap.scale)),
        "quats": quats_all,
        "features_dc": put((rgb - 0.5) / SH_C0),
        "features_rest": put(rest),
        "opacities": put(torch.log(op / (1.0 - op))),
        "alive": alive,
    }
