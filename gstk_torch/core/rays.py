"""Per-pixel camera rays + scene colliders (port of ``gstk_tpu/core/rays.py``).

Equivalent of the reference's ray machinery used outside the splat hot path
(``gs_toolkit/cameras/cameras.py:344`` generate_rays,
``gs_toolkit/cameras/rays.py`` RayBundle,
``gs_toolkit/model_components/scene_colliders.py``): pixel ray generation for
point-cloud backprojection/colliders, and AABB / sphere / near-far colliders
returning per-ray [near, far] ranges. Torch, f32, on the camera's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gstk_torch.core.cameras import Camera


class RayBundle(NamedTuple):
    origins: torch.Tensor  # (..., 3)
    directions: torch.Tensor  # (..., 3) unit
    nears: Optional[torch.Tensor] = None  # (...,)
    fars: Optional[torch.Tensor] = None


def _pixel_grid(camera: Camera, img_height: int, img_width: int,
                offset: float = 0.0):
    """(ys, xs) f32 pixel coordinates, each (H, W), plus ``offset``."""
    dev = camera.c2w.device
    ys, xs = torch.meshgrid(
        torch.arange(img_height, dtype=torch.float32, device=dev) + offset,
        torch.arange(img_width, dtype=torch.float32, device=dev) + offset,
        indexing="ij",
    )
    return ys, xs


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def generate_rays(
    camera: Camera, img_height: int, img_width: int
) -> RayBundle:
    """World-space rays through every pixel center (OpenGL c2w convention:
    camera looks along -z)."""
    ys, xs = _pixel_grid(camera, img_height, img_width)
    x_c = (xs + 0.5 - camera.cx) / camera.fx
    y_c = (ys + 0.5 - camera.cy) / camera.fy
    dirs_cam = torch.stack([x_c, -y_c, -torch.ones_like(x_c)], dim=-1)
    dirs_world = _unit(dirs_cam @ camera.c2w[:3, :3].T)
    origins = camera.c2w[:3, 3].expand(dirs_world.shape)
    return RayBundle(origins=origins, directions=dirs_world)


def aabb_collider(
    rays: RayBundle, aabb: torch.Tensor, near_plane: float = 0.0
) -> RayBundle:
    """Slab-test AABB intersection (scene_colliders.py AABBBoxCollider)."""
    d = rays.directions
    inv = 1.0 / torch.where(d.abs() < 1e-10, torch.full_like(d, 1e-10), d)
    t0 = (aabb[0] - rays.origins) * inv
    t1 = (aabb[1] - rays.origins) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    nears = torch.clamp(tmin, min=near_plane)
    fars = torch.maximum(tmax, nears + 1e-6)
    return rays._replace(nears=nears, fars=fars)


def sphere_collider(
    rays: RayBundle, center, radius: float, near_plane: float = 0.0
) -> RayBundle:
    """Ray-sphere intersection (scene_colliders.py SphereCollider)."""
    c = torch.as_tensor(center, dtype=rays.origins.dtype,
                        device=rays.origins.device)
    oc = rays.origins - c
    b = (oc * rays.directions).sum(dim=-1)
    cc = (oc * oc).sum(dim=-1) - radius * radius
    disc = torch.clamp(b * b - cc, min=0.0)
    sq = torch.sqrt(disc)
    nears = torch.clamp(-b - sq, min=near_plane)
    fars = torch.maximum(-b + sq, nears + 1e-6)
    return rays._replace(nears=nears, fars=fars)


def near_far_collider(
    rays: RayBundle, near: float, far: float
) -> RayBundle:
    """Constant [near, far] (scene_colliders.py NearFarCollider)."""
    shape = rays.origins.shape[:-1]
    kw = dict(dtype=torch.float32, device=rays.origins.device)
    return rays._replace(nears=torch.full(shape, near, **kw),
                         fars=torch.full(shape, far, **kw))


def _spherical_dirs(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Local camera directions from spherical angles (reference
    cameras.py:578-1118 equirect convention: +y up, theta=0 looks along
    -z, right-handed minus sign on theta)."""
    return torch.stack(
        [
            -torch.sin(theta) * torch.sin(phi),
            torch.cos(phi),
            -torch.cos(theta) * torch.sin(phi),
        ],
        dim=-1,
    )


def generate_equirect_rays(
    camera: Camera, img_height: int, img_width: int
) -> RayBundle:
    """Equirectangular panorama rays: theta spans +/-pi across the width,
    phi spans [0, pi] down the height (reference cameras.py EQUIRECTANGULAR
    branch: fx = fy = height = width/2 convention)."""
    ys, xs = _pixel_grid(camera, img_height, img_width, 0.5)
    u = (xs - img_width / 2.0) / img_width  # [-1/2, 1/2]
    v = (ys - img_height / 2.0) / img_height
    theta = -2.0 * math.pi * u
    # reference applies the OpenCV->OpenGL flip (coord1 *= -1) before
    # phi = pi*(0.5 - coord1)  =>  phi = pi*(0.5 + v) in raw row coords
    phi = math.pi * (0.5 + v)
    dirs_world = _spherical_dirs(theta, phi) @ camera.c2w[:3, :3].T
    origins = camera.c2w[:3, 3].expand(dirs_world.shape)
    return RayBundle(origins=origins, directions=dirs_world)


def generate_ods_rays(
    camera: Camera,
    img_height: int,
    img_width: int,
    eye: str = "left",
    ipd: float = 0.064,
) -> RayBundle:
    """Omni-directional stereo: equirect directions with per-column ray
    origins on a horizontal IPD circle (reference cameras.py
    _compute_rays_for_omnidirectional_stereo)."""
    rays = generate_equirect_rays(camera, img_height, img_width)
    xs = torch.arange(img_width, dtype=torch.float32,
                      device=camera.c2w.device) + 0.5
    u = (xs - img_width / 2.0) / img_width
    ods_theta = -2.0 * math.pi * u  # (W,)
    sign = 1.0 if eye == "right" else -1.0
    # circle in local camera coords: x-axis * cos + (-z axis) * sin
    local = sign * (ipd / 2.0) * torch.stack(
        [torch.cos(ods_theta), torch.zeros_like(ods_theta),
         -torch.sin(ods_theta)],
        dim=-1,
    )  # (W, 3)
    world_off = local @ camera.c2w[:3, :3].T
    origins = camera.c2w[:3, 3] + world_off  # (W, 3)
    return rays._replace(origins=origins[None].expand(rays.directions.shape))


def generate_vr180_rays(
    camera: Camera,
    img_height: int,
    img_width: int,
    eye: str = "left",
    ipd: float = 0.064,
) -> RayBundle:
    """VR180: half-sphere equirect (theta in +/-pi/2) with a fixed
    interocular offset along the camera x axis (reference cameras.py
    _compute_rays_for_vr180)."""
    ys, xs = _pixel_grid(camera, img_height, img_width, 0.5)
    u = (xs - img_width / 2.0) / img_width
    v = (ys - img_height / 2.0) / img_height
    theta = -math.pi * u  # +/- pi/2 across the width
    phi = math.pi * (0.5 + v)
    dirs_world = _spherical_dirs(theta, phi) @ camera.c2w[:3, :3].T
    sign = 1.0 if eye == "right" else -1.0
    off = sign * (ipd / 2.0) * camera.c2w[:3, 0]
    origins = (camera.c2w[:3, 3] + off).expand(dirs_world.shape)
    return RayBundle(origins=origins, directions=dirs_world)


def generate_orthographic_rays(
    camera: Camera, img_height: int, img_width: int
) -> RayBundle:
    """Orthophoto rays: parallel -z directions, origins on the image-plane
    grid scaled by 1/f (reference cameras.py ORTHOPHOTO branch)."""
    ys, xs = _pixel_grid(camera, img_height, img_width, 0.5)
    x_c = (xs - camera.cx) / camera.fx
    y_c = -(ys - camera.cy) / camera.fy
    grid = torch.stack([x_c, y_c, torch.zeros_like(x_c)], dim=-1)
    origins = grid @ camera.c2w[:3, :3].T + camera.c2w[:3, 3]
    d = -camera.c2w[:3, 2]
    d = d / torch.linalg.norm(d)
    return RayBundle(origins=origins, directions=d.expand(origins.shape))


def generate_fisheye624_rays(
    camera: Camera,
    img_height: int,
    img_width: int,
    distortion_params,  # (12,) [k0..k5 p0 p1 s0..s3]
) -> RayBundle:
    """Fisheye624 rays via the Newton unprojection
    (gstk_torch.core.fisheye624; reference cameras.py FISHEYE624 branch)."""
    from gstk_torch.core.fisheye624 import fisheye624_unproject

    dev = camera.c2w.device
    ys, xs = _pixel_grid(camera, img_height, img_width, 0.5)
    uv = torch.stack([xs, ys], dim=-1)
    params = torch.cat([
        torch.stack([camera.fx, camera.fy, camera.cx, camera.cy]),
        torch.as_tensor(distortion_params, dtype=torch.float32, device=dev),
    ])
    d_cv = fisheye624_unproject(uv, params)
    # OpenCV (+z forward, +y down) -> OpenGL camera space
    flip = torch.tensor([1.0, -1.0, -1.0], device=dev)
    dirs_world = _unit((d_cv * flip) @ camera.c2w[:3, :3].T)
    origins = camera.c2w[:3, 3].expand(dirs_world.shape)
    return RayBundle(origins=origins, directions=dirs_world)
