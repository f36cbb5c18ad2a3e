"""Raytraced synthetic dataset: a high-fidelity offline stand-in for a real
captured scene (port of ``gstk_tpu/data/raytraced.py``).

This module raytraces an *analytic* textured scene (checkered ground plane,
marble/striped/checkered spheres, colored boxes) with Lambertian shading,
two lights and hard shadows, and writes the standard dataset layout
(images/, depths/, sparse.ply seed cloud, transforms.json) that gs-train
consumes. Unlike the Gaussian-rendered generator (``synthetic.py``), its
ground truth is not itself made of Gaussians, so view-dependent shading,
sharp texture edges, occlusion boundaries and shadows give the densifier
and the SH bands something real to fit.

The arithmetic is gstk_tpu's, in torch float64 on ``device`` (``cuda``
unless given):
  * ``_hash3`` multiplies int64 with wrapping overflow and shifts
    arithmetically, as numpy does; ``% 2`` of negative cells is the floor
    remainder (``torch.remainder``), as numpy's;
  * the rays are rotated into the world on the host by numpy's matrix
    product, as gstk_tpu rotates them, and uploaded; the 3-term dot
    products and norms on the device are written out in numpy's summation
    order, so the CPU and the card evaluate them alike;
  * with ``supersample`` ss > 1 the centre ray and the ss² sub-rays of a
    view are shaded in one batch, and the sub-images are then added one at
    a time in gstk_tpu's ``sub_dirs`` order;
  * the image and depth are truncated to uint8 / uint16 on the host in
    numpy, and the seed cloud draws from ``np.random.default_rng(seed)``,
    so the hit mask goes to the host once a view.
PNGs are written by :func:`gstk_torch.utils.io.write_png`.

Cameras use the OpenGL c2w convention (look along -z, y up); depth maps
store view-space z in millimeters (16-bit png), matching the dataparser
contract. The seed cloud backprojects shaded hit points from the training
views with small positional noise — an honest SfM analog.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.utils.io import write_ply, write_png

F64 = torch.float64


# ----------------------------------------------------------------------
# vector helpers, in numpy's order of summation
# ----------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (N, 3) arrays, ((a0 b0 + a1 b1) + a2 b2)."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _norm(a: torch.Tensor) -> torch.Tensor:
    """(N, 1) row norms of an (N, 3) array."""
    return torch.sqrt(_dot(a, a))[:, None]


def _vec(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), dtype=F64, device=device)


# ----------------------------------------------------------------------
# procedural textures
# ----------------------------------------------------------------------

def _hash3(ix, iy, iz, seed):
    """[0, 1] hash of integer cells (float64 tensors holding integers);
    int64 arithmetic wraps on overflow and ``>>`` is arithmetic, as in
    numpy."""
    h = (
        ix.to(torch.int64) * 374761393
        + iy.to(torch.int64) * 668265263
        + iz.to(torch.int64) * 2147483647
        + int(seed) * 104729
    )
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(F64) / float(0xFFFFFF)


def _value_noise(p, seed=0):
    """Trilinear value noise in [0,1], p (N,3)."""
    pf = torch.floor(p)
    f = p - pf
    f = f * f * (3.0 - 2.0 * f)
    ix, iy, iz = pf[:, 0], pf[:, 1], pf[:, 2]
    n = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                n = n + w * _hash3(ix + dx, iy + dy, iz + dz, seed)
    return n


def _fbm(p, octaves=4, seed=0):
    out = torch.zeros(p.shape[0], dtype=F64, device=p.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        out += amp * _value_noise(p * freq, seed + o)
        norm += amp
        amp *= 0.5
        freq *= 2.17
    return out / norm


def _checker(p, scale=1.0):
    q = torch.floor(p * scale).to(torch.int64)
    return torch.remainder(q[:, 0] + q[:, 2], 2).to(F64)


# ----------------------------------------------------------------------
# scene primitives
# ----------------------------------------------------------------------

class _Sphere:
    def __init__(self, center, radius, tex):
        self.center = np.asarray(center, np.float64)
        self.r = float(radius)
        self.tex = tex

    def intersect(self, o, d):
        # rays are unnormalized (pinhole z = -1), so keep the full
        # quadratic a t^2 + 2 b t + c with a = d.d
        oc = o - _vec(self.center, o.device)
        a = _dot(d, d)
        b = _dot(oc, d)
        c = _dot(oc, oc) - self.r * self.r
        disc = b * b - a * c
        ok = disc > 0
        sq = torch.sqrt(torch.clamp(disc, min=0))
        inf = torch.full_like(disc, float("inf"))
        t = torch.where(ok, (-b - sq) / a, inf)
        t = torch.where(t > 1e-4, t, torch.where(ok, (-b + sq) / a, inf))
        return torch.where(t > 1e-4, t, inf)

    def normal(self, p):
        n = p - _vec(self.center, p.device)
        return n / _norm(n)

    def albedo(self, p):
        return self.tex(p, self)


class _Box:
    def __init__(self, lo, hi, tex):
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.tex = tex

    def intersect(self, o, d):
        inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        t0 = (_vec(self.lo, o.device) - o) * inv
        t1 = (_vec(self.hi, o.device) - o) * inv
        tmin = torch.minimum(t0, t1).amax(dim=1)
        tmax = torch.maximum(t0, t1).amin(dim=1)
        hit = tmax > torch.clamp(tmin, min=1e-4)
        return torch.where(hit & (tmin > 1e-4), tmin,
                           torch.full_like(tmin, float("inf")))

    def normal(self, p):
        eps = 1e-4
        cols = []
        for a in range(3):
            lo_f = (p[:, a] - float(self.lo[a])).abs() < eps
            hi_f = (p[:, a] - float(self.hi[a])).abs() < eps
            col = torch.zeros_like(p[:, a])
            col = torch.where(lo_f, torch.full_like(col, -1.0), col)
            cols.append(torch.where(hi_f, torch.full_like(col, 1.0), col))
        n = torch.stack(cols, dim=1)
        nl = _norm(n)
        return n / torch.where(nl == 0, torch.ones_like(nl), nl)

    def albedo(self, p):
        return self.tex(p, self)


class _Plane:
    """y = const ground plane."""

    def __init__(self, y, tex):
        self.y = float(y)
        self.tex = tex

    def intersect(self, o, d):
        dy = d[:, 1]
        t = (self.y - o[:, 1]) / torch.where(dy.abs() < 1e-12,
                                              torch.full_like(dy, 1e-12), dy)
        return torch.where(t > 1e-4, t, torch.full_like(t, float("inf")))

    def normal(self, p):
        n = torch.zeros_like(p)
        n[:, 1] = 1.0
        return n

    def albedo(self, p):
        return self.tex(p, self)


# ----------------------------------------------------------------------
# textures
# ----------------------------------------------------------------------

def _tex_ground(p, _):
    ck = _checker(p, 0.9)[:, None]
    a = _vec([0.82, 0.78, 0.72], p.device)
    b = _vec([0.28, 0.3, 0.36], p.device)
    base = ck * a + (1 - ck) * b
    dust = _fbm(p * 0.7, 3, seed=11)[:, None]
    return base * (0.8 + 0.4 * dust)


def _tex_marble(tint):
    def tex(p, _):
        v = _fbm(p * 2.2, 4, seed=5)
        veins = 0.5 + 0.5 * torch.sin(6.0 * p[:, 1] + 9.0 * v)
        return (0.25 + 0.75 * veins[:, None]) * _vec(tint, p.device)

    return tex


def _tex_stripes(c1, c2, freq=8.0, axis=1):
    def tex(p, obj):
        rel = p - _vec(obj.center, p.device)
        s = 0.5 + 0.5 * torch.sin(freq * torch.atan2(rel[:, 2], rel[:, 0]))
        band = (s > 0.5).to(F64)[:, None]
        return band * _vec(c1, p.device) + (1 - band) * _vec(c2, p.device)

    return tex


def _tex_check_faces(c1, c2, scale=3.0):
    def tex(p, _):
        q = torch.floor(p * scale).to(torch.int64)
        ck = torch.remainder(q[:, 0] + q[:, 1] + q[:, 2], 2).to(F64)[:, None]
        return ck * _vec(c1, p.device) + (1 - ck) * _vec(c2, p.device)

    return tex


def _tex_noise(tint, freq=3.0, seed=23):
    def tex(p, _):
        v = _fbm(p * freq, 4, seed=seed)[:, None]
        return (0.3 + 0.7 * v) * _vec(tint, p.device)

    return tex


def build_scene():
    """The fixed benchmark scene: ground + 8 textured primitives."""
    objs = [
        _Plane(-1.2, _tex_ground),
        _Sphere([0.0, -0.2, 0.0], 1.0, _tex_marble([0.9, 0.85, 0.8])),
        _Sphere([1.9, -0.65, 0.9], 0.55, _tex_stripes(
            [0.85, 0.2, 0.15], [0.95, 0.85, 0.3], freq=10.0)),
        _Sphere([-1.8, -0.5, 1.2], 0.7, _tex_noise([0.2, 0.55, 0.9], 4.0)),
        _Sphere([-1.2, -0.85, -1.6], 0.35, _tex_stripes(
            [0.15, 0.7, 0.35], [0.9, 0.9, 0.95], freq=14.0)),
        _Box([0.9, -1.2, -2.2], [1.9, -0.2, -1.2],
             _tex_check_faces([0.85, 0.5, 0.15], [0.3, 0.2, 0.5], 2.5)),
        _Box([-2.6, -1.2, -0.6], [-1.9, 0.1, 0.1],
             _tex_noise([0.75, 0.3, 0.55], 5.0, seed=41)),
        _Sphere([0.9, -0.9, 2.1], 0.3, _tex_marble([0.4, 0.9, 0.6])),
        _Box([-0.5, -1.2, 2.0], [0.3, -0.7, 2.6],
             _tex_check_faces([0.2, 0.75, 0.8], [0.95, 0.95, 0.9], 4.0)),
    ]
    return objs


_L1 = np.array([0.45, 1.0, 0.35])
_L1 /= np.linalg.norm(_L1)
_L2 = np.array([-0.55, 0.55, -0.3])
_L2 /= np.linalg.norm(_L2)


def _trace(objs, o, d):
    """Nearest hit: returns (t, obj_idx). o,d (N,3); t inf on miss."""
    t_best = torch.full((o.shape[0],), float("inf"), dtype=F64, device=o.device)
    idx = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for i, obj in enumerate(objs):
        t = obj.intersect(o, d)
        m = t < t_best
        t_best = torch.where(m, t, t_best)
        idx = torch.where(m, torch.full_like(idx, i), idx)
    return t_best, idx


def _occluded(objs, p, light_dir):
    light = _vec(light_dir, p.device)
    o = p + light * 1e-3
    d = light.expand(o.shape)
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for obj in objs:
        occ |= torch.isfinite(obj.intersect(o, d))
    return occ


def shade(objs, o, d):
    """Returns (rgb (N,3) in [0,1], depth_t (N,), hit mask)."""
    t, idx = _trace(objs, o, d)
    hit = torch.isfinite(t)
    rgb = torch.zeros((o.shape[0], 3), dtype=F64, device=o.device)
    if not bool(hit.any()):
        return rgb, t, hit
    ph = o[hit] + d[hit] * t[hit, None]
    nh = torch.zeros_like(ph)
    alb = torch.zeros_like(ph)
    idx_hit = idx[hit]
    for i, obj in enumerate(objs):
        m = idx_hit == i
        if bool(m.any()):
            nh[m] = obj.normal(ph[m])
            alb[m] = obj.albedo(ph[m])
    lam1 = torch.clamp(_dot(nh, _vec(_L1, o.device).expand(nh.shape)), min=0.0)
    shadow = _occluded(objs, ph, _L1)
    lam1 = torch.where(shadow, torch.zeros_like(lam1), lam1)
    lam2 = torch.clamp(_dot(nh, _vec(_L2, o.device).expand(nh.shape)), min=0.0)
    amb = 0.16 + 0.06 * torch.clamp(nh[:, 1], min=0.0)
    lum = 0.95 * lam1 + 0.32 * lam2 + amb
    rgb[hit] = torch.clamp(alb * lum[:, None], 0.0, 1.0)
    return rgb, t, hit


def _orbit_pose(radius, height, angle, target=(0.0, -0.4, 0.0)):
    """OpenGL c2w looking at target from an orbit position (numpy)."""
    eye = np.array(
        [radius * np.cos(angle), height, radius * np.sin(angle)]
    )
    target = np.asarray(target)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up2
    c2w[:3, 2] = -fwd  # OpenGL: camera looks along -z
    c2w[:3, 3] = eye
    return c2w


def view_pose(i: int, n_views: int) -> np.ndarray:
    """View ``i``'s c2w: three orbit rings, interleaved."""
    ring = i % 3
    radius = (7.2, 6.2, 5.2)[ring]
    height = (1.2, 2.8, 4.2)[ring]
    angle = 2 * np.pi * i / n_views + 0.21 * ring
    return _orbit_pose(radius, height, angle)


def camera_dirs(w: int, h: int, fx: float, cx: float, cy: float,
                supersample: int = 1) -> list:
    """Camera-space ray directions (H*W, 3), float64 numpy: the pixel
    centres', then with ``supersample`` ss > 1 the ss² stratified sets in
    gstk_tpu's ``sub_dirs`` order."""
    ss = max(int(supersample), 1)
    offsets = [(0.5, 0.5)]
    if ss > 1:
        grid = (np.arange(ss) + 0.5) / ss
        offsets += [(ox, oy) for oy in grid for ox in grid]
    dirs = []
    for ox, oy in offsets:
        u, v = np.meshgrid(np.arange(w) + ox, np.arange(h) + oy)
        dirs.append(np.stack(
            [(u - cx) / fx, -(v - cy) / fx, -np.ones_like(u)], axis=-1
        ).reshape(-1, 3))
    return dirs


def render_view(objs, c2w: np.ndarray, dirs: list, device=None,
                centre: bool = False):
    """Shade one view on ``device``: (rgb (N, 3) float64 in [0, 1], centre
    ray t (N,), hit (N,) bool, centre world directions (N, 3)), tensors on
    the device. ``dirs`` is :func:`camera_dirs`'s list; with more than one
    set, rgb is the box filter of the stratified sets and hit their
    majority, and t stays the centre ray's. With ``centre`` the tuple goes
    on with the centre ray's own rgb and hit (the sharded capture's depth
    mask and seed colours).

    The directions are rotated into the world on the host, by numpy's
    matrix product as in gstk_tpu: a box face on a checker boundary (the
    z = -1.2 face at scale 2.5) takes its colour from the last bit of the
    hit point, so the rays must agree bit for bit."""
    n = dirs[0].shape[0]
    d_all = torch.from_numpy(
        np.concatenate([sd @ c2w[:3, :3].T for sd in dirs])).to(device)
    o_all = _vec(c2w[:3, 3], device).expand(d_all.shape)
    rgb_all, t_all, hit_all = shade(objs, o_all, d_all)
    rgb, t, hit, d = rgb_all[:n], t_all[:n], hit_all[:n], d_all[:n]
    subs = len(dirs) - 1
    if subs:
        acc = torch.zeros_like(rgb)
        acc_hit = torch.zeros(n, dtype=F64, device=device)
        for k in range(1, subs + 1):
            acc += rgb_all[k * n:(k + 1) * n]
            acc_hit += hit_all[k * n:(k + 1) * n].to(F64)
        rgb = acc / subs
        hit = acc_hit / subs >= 0.5
    if centre:
        return rgb, t, hit, d, rgb_all[:n], hit_all[:n]
    return rgb, t, hit, d


def view_images(rgb: np.ndarray, t: np.ndarray, hit: np.ndarray, h: int,
                w: int):
    """A shaded view's files, truncated on the host as gstk_tpu truncates
    them: (RGBA uint8 (h, w, 4), depth in mm uint16 (h, w))."""
    img = np.zeros((h * w, 4), np.uint8)
    img[:, :3] = (rgb * 255).astype(np.uint8)
    img[:, 3] = np.where(hit, 255, 0)
    # depth = view-space z = t (the centre directions have z = -1)
    depth_mm = np.where(hit, t * 1000.0, 0.0)
    depth_mm = np.clip(depth_mm, 0, 65535).astype(np.uint16)
    return img.reshape(h, w, 4), depth_mm.reshape(h, w)


def generate_raytraced_dataset(
    out_dir: Path,
    n_views: int = 64,
    img_wh: Tuple[int, int] = (800, 800),
    seed_points: int = 160_000,
    seed: int = 0,
    fov_deg: float = 40.0,
    supersample: int = 1,
    device: DeviceLike = None,
) -> Path:
    """Raytrace the benchmark scene on ``device`` (cuda unless given) and
    write a full dataset directory; returns it.

    ``supersample``: rays per pixel axis (ss*ss stratified rays,
    box-filtered). The default 1 matches the original datasets, but a
    1-spp GT carries view-incoherent speckle above Nyquist at grazing
    incidence; use >= 3 for band-limited GT whose eval PSNR measures the
    model, not the dataset. Depth stays 1-spp (center ray): averaging
    depth across an edge would invent midair surfaces for the sensor-depth
    losses."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    (out_dir / "depths").mkdir(exist_ok=True)
    w, h = img_wh
    fx = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    cx, cy = w / 2.0, h / 2.0
    objs = build_scene()
    dirs = camera_dirs(w, h, fx, cx, cy, supersample)

    frames = []
    cloud_pts, cloud_rgb = [], []
    for i in range(n_views):
        c2w = view_pose(i, n_views)
        rgb_d, t_d, hit_d, d_d = render_view(objs, c2w, dirs, device)
        rgb, t, hit = (x.cpu().numpy() for x in (rgb_d, t_d, hit_d))
        img, depth_mm = view_images(rgb, t, hit, h, w)
        name = f"frame_{i:05d}.png"
        write_png(out_dir / "images" / name, img)
        dname = f"depth_{i:05d}.png"
        write_png(out_dir / "depths" / dname, depth_mm)
        frames.append({
            "file_path": f"images/{name}",
            "depth_path": f"depths/{dname}",
            "transform_matrix": c2w.tolist(),
        })

        # SfM-like seed samples: sparse backprojected shaded points
        hit_idx = np.flatnonzero(hit)
        if hit_idx.size:
            take = rng.choice(
                hit_idx, min(4000, hit_idx.size), replace=False
            )
            d = d_d[torch.from_numpy(take).to(device)].cpu().numpy()
            p = c2w[:3, 3] + d * t[take, None]
            p = p + rng.normal(0, 0.004, p.shape)
            cloud_pts.append(p.astype(np.float32))
            cloud_rgb.append((rgb[take] * 255).astype(np.float32))

    pts = np.concatenate(cloud_pts)
    cols = np.concatenate(cloud_rgb)
    if pts.shape[0] > seed_points:
        sel = rng.choice(pts.shape[0], seed_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    write_ply(
        out_dir / "sparse.ply",
        {
            "vertex": {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "red": cols[:, 0].astype(np.uint8),
                "green": cols[:, 1].astype(np.uint8),
                "blue": cols[:, 2].astype(np.uint8),
            }
        },
    )
    meta = {
        "fl_x": fx, "fl_y": fx, "cx": cx, "cy": cy, "w": w, "h": h,
        "camera_model": "OPENCV",
        "ply_file_path": "sparse.ply",
        "frames": frames,
    }
    with open(out_dir / "transforms.json", "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("gs-raytraced-data")
    ap.add_argument("--output-dir", type=Path, required=True)
    ap.add_argument("--n-views", type=int, default=64)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--seed-points", type=int, default=160_000)
    ap.add_argument("--supersample", type=int, default=1,
                    help="rays per pixel axis; >=3 for band-limited GT "
                         "(see generate_raytraced_dataset docstring)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = generate_raytraced_dataset(
        args.output_dir, args.n_views, (args.width, args.height),
        args.seed_points, supersample=args.supersample, device=args.device,
    )
    print(f"Raytraced dataset written to {out}")


if __name__ == "__main__":
    main()
