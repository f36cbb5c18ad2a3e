"""TSDF fusion and mesh extraction (port of ``gstk_tpu/exporter/tsdf.py``).

  * A dense TSDF integrator in PyTorch on the volume's device: every frame
    projects the whole voxel grid through the camera and blends the
    truncated SDF and the color with running weights (a loop over frames;
    the voxel centres are built once for all frames).
  * Mesh extraction by marching tetrahedra (numpy, on the host): each cube
    splits into 6 tetrahedra whose 16 sign cases are derived in code, giving
    a watertight triangulation of the zero level set.
  * Vertex colors sampled from the color volume.

The mesh is written by :func:`write_mesh_ply`. Semantics as gstk_tpu's:
``round`` is half to even in both packages, and every division by a
constant divides by a device tensor (on the card a division by a host value
runs as a multiplication by its reciprocal, which gstk_tpu's does not).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device


@dataclasses.dataclass
class TSDFVolume:
    tsdf: torch.Tensor  # (X, Y, Z) truncated SDF in [-1, 1]
    weights: torch.Tensor  # (X, Y, Z)
    colors: torch.Tensor  # (X, Y, Z, 3)
    origin: torch.Tensor  # (3,) world position of voxel (0, 0, 0)
    voxel_size: float


def make_volume(origin, size_xyz, voxel_size: float,
                device: DeviceLike = None) -> TSDFVolume:
    """An empty volume on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    dims = tuple(int(np.ceil(s / voxel_size)) for s in size_xyz)
    return TSDFVolume(
        tsdf=torch.ones(dims, dtype=torch.float32, device=device),
        weights=torch.zeros(dims, dtype=torch.float32, device=device),
        colors=torch.zeros(dims + (3,), dtype=torch.float32, device=device),
        origin=torch.as_tensor(origin, dtype=torch.float32, device=device),
        voxel_size=float(voxel_size),
    )


def _voxel_centres(vol: TSDFVolume) -> torch.Tensor:
    """(X, Y, Z, 3) world positions of the voxels, on the volume's device."""
    dev = vol.tsdf.device
    axes = [torch.arange(n, device=dev) for n in vol.tsdf.shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return grid.to(torch.float32) * vol.voxel_size + vol.origin


def _integrate_one(
    vol: TSDFVolume,
    pts: torch.Tensor,  # (X, Y, Z, 3) voxel centres
    depth: torch.Tensor,  # (H, W) meters, 0 = invalid
    color: torch.Tensor,  # (H, W, 3) in [0, 1]
    intrinsics: torch.Tensor,  # (4,) fx fy cx cy
    w2c: torch.Tensor,  # (4, 4) world->camera, OpenCV (+z forward)
    sdf_trunc: torch.Tensor,  # () on the volume's device
) -> TSDFVolume:
    h, w = depth.shape
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[..., 2]
    z_safe = torch.where(z <= 1e-6, 1.0, z)
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    u = torch.round(fx * cam[..., 0] / z_safe + cx).to(torch.int32)
    v = torch.round(fy * cam[..., 1] / z_safe + cy).to(torch.int32)
    in_img = (z > 1e-6) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc = torch.clamp(u, 0, w - 1).long()
    vc = torch.clamp(v, 0, h - 1).long()
    d = depth[vc, uc]
    valid = in_img & (d > 0)
    sdf = d - z
    valid = valid & (sdf > -sdf_trunc)
    tsdf_new = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)
    w_new = valid.to(torch.float32)
    w_tot = vol.weights + w_new
    w_tot_safe = torch.clamp(w_tot, min=1e-6)
    tsdf = (vol.tsdf * vol.weights + tsdf_new * w_new) / w_tot_safe
    col_new = color[vc, uc]
    colors = (
        vol.colors * vol.weights[..., None] + col_new * w_new[..., None]
    ) / w_tot_safe[..., None]
    return dataclasses.replace(
        vol,
        tsdf=torch.where(w_tot > 0, tsdf, vol.tsdf),
        weights=w_tot,
        colors=torch.where(w_tot[..., None] > 0, colors, vol.colors),
    )


def integrate_frames(
    vol: TSDFVolume,
    depths,  # (N, H, W)
    colors,  # (N, H, W, 3)
    intrinsics,  # (N, 4)
    w2cs,  # (N, 4, 4)
    sdf_trunc: float,
) -> TSDFVolume:
    """Integrate N frames (numpy arrays or tensors) one after another on
    the volume's device; each frame is moved there as it comes."""
    dev = vol.tsdf.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    pts = _voxel_centres(vol)
    trunc = torch.full((), sdf_trunc, dtype=torch.float32, device=dev)
    for i in range(len(depths)):
        vol = _integrate_one(vol, pts, f32(depths[i]), f32(colors[i]),
                             f32(intrinsics[i]), f32(w2cs[i]), trunc)
    return vol


# ---------------------------------------------------------------------------
# Marching tetrahedra (host-side numpy)
# ---------------------------------------------------------------------------

# Each cube [0,1]^3 splits into 6 tetrahedra sharing the main diagonal 0-7.
# Cube corner k has coords ((k>>0)&1, (k>>1)&1, (k>>2)&1) in (x, y, z).
_TETS = np.array(
    [
        [0, 5, 1, 7],
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
    ],
    np.int32,
)
_CORNER = np.array(
    [[(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1] for k in range(8)], np.int32
)


def _tet_triangles(inside: np.ndarray):
    """Triangle edge lists for one tetra sign pattern (4 bools).

    Returns list of triangles, each a list of 3 (a, b) vertex-index pairs
    denoting interpolated edge crossings between tet-local vertices a, b."""
    pos = [i for i in range(4) if inside[i]]
    neg = [i for i in range(4) if not inside[i]]
    if len(pos) == 0 or len(neg) == 0:
        return []
    if len(pos) == 1:
        p = pos[0]
        e = [(p, n) for n in neg]
        return [[e[0], e[1], e[2]]]
    if len(pos) == 3:
        n = neg[0]
        e = [(p, n) for p in pos]
        return [[e[0], e[2], e[1]]]
    # 2-2 case: quad between the four crossing edges
    a, b = pos
    c, d = neg
    e_ac, e_ad, e_bc, e_bd = (a, c), (a, d), (b, c), (b, d)
    return [[e_ac, e_ad, e_bd], [e_ac, e_bd, e_bc]]


def marching_tetrahedra(
    tsdf: np.ndarray,
    weights: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    origin=(0.0, 0.0, 0.0),
    voxel_size: float = 1.0,
    min_weight: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Extract the zero level set. Returns (vertices (V,3), faces (F,3),
    vertex colors (V,3) or None). Vectorized over all cubes."""
    tsdf = np.asarray(tsdf)
    valid = (
        np.asarray(weights) > min_weight
        if weights is not None
        else np.ones_like(tsdf, bool)
    )
    nx, ny, nz = tsdf.shape
    # corner values per cube: (nx-1, ny-1, nz-1, 8)
    cval = np.empty((nx - 1, ny - 1, nz - 1, 8), tsdf.dtype)
    cvalid = np.empty((nx - 1, ny - 1, nz - 1, 8), bool)
    for k in range(8):
        dx, dy, dz = _CORNER[k]
        cval[..., k] = tsdf[dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz]
        cvalid[..., k] = valid[
            dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz
        ]
    cube_ok = cvalid.all(axis=-1)
    # cubes with >=1 inside (<0) and >=1 outside (>=0) corner — the half-open
    # convention must match the `< 0` inside test below, or a level set
    # passing exactly through grid points is missed
    straddle = (cval.min(axis=-1) < 0) & (cval.max(axis=-1) >= 0) & cube_ok
    idx = np.argwhere(straddle)
    if idx.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64), None
    vals = cval[straddle]  # (C, 8)
    base = idx.astype(np.float64)  # cube origin in voxel coords

    verts_list, faces_list = [], []
    vert_count = 0
    for tet in _TETS:
        tvals = vals[:, tet]  # (C, 4)
        inside = tvals < 0
        code = (
            inside[:, 0].astype(int)
            + 2 * inside[:, 1]
            + 4 * inside[:, 2]
            + 8 * inside[:, 3]
        )
        for c in range(16):
            pattern = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1, (c >> 3) & 1], bool)
            tris = _tet_triangles(pattern)
            if not tris:
                continue
            sel = code == c
            if not sel.any():
                continue
            sub_vals = tvals[sel]  # (S, 4)
            sub_base = base[sel]  # (S, 3)
            for tri in tris:
                tri_pts = []
                for (a, b) in tri:
                    va = sub_vals[:, a]
                    vb = sub_vals[:, b]
                    t = va / (va - vb + 1e-12)
                    pa = _CORNER[tet[a]]
                    pb = _CORNER[tet[b]]
                    p = sub_base + pa + t[:, None] * (pb - pa)
                    tri_pts.append(p)
                s = tri_pts[0].shape[0]
                verts_list.append(np.stack(tri_pts, axis=1).reshape(-1, 3))
                faces_list.append(
                    np.arange(3 * s).reshape(s, 3) + vert_count
                )
                vert_count += 3 * s

    verts = np.concatenate(verts_list, axis=0)
    faces = np.concatenate(faces_list, axis=0)
    # weld duplicate vertices
    keys = np.round(verts / (voxel_size * 1e-6 + 1e-9)).astype(np.int64)
    _, uniq_idx, inv = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    verts = verts[uniq_idx]
    faces = inv[faces]
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]

    world = verts * voxel_size + np.asarray(origin)
    vcols = None
    if colors is not None:
        colors = np.asarray(colors)
        vi = np.clip(np.round(verts).astype(int), 0, np.array(tsdf.shape) - 1)
        vcols = colors[vi[:, 0], vi[:, 1], vi[:, 2]]
    return world.astype(np.float32), faces.astype(np.int64), vcols


def write_mesh_ply(path, vertices, faces, vertex_colors=None) -> None:
    """Binary PLY mesh with a face list property."""
    n, f = len(vertices), len(faces)
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    if vertex_colors is not None:
        header += [
            "property uchar red", "property uchar green", "property uchar blue"
        ]
    header += [
        f"element face {f}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as out:
        out.write(("\n".join(header) + "\n").encode("ascii"))
        v = np.asarray(vertices, np.float32)
        if vertex_colors is not None:
            c = (np.clip(np.asarray(vertex_colors), 0, 1) * 255).astype(np.uint8)
            rec = np.empty(
                n,
                dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("r", "u1"), ("g", "u1"), ("b", "u1")],
            )
            rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
            rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]
        else:
            rec = np.empty(
                n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            )
            rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
        out.write(rec.tobytes())
        frec = np.empty(
            f, dtype=[("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")]
        )
        frec["n"] = 3
        fa = np.asarray(faces, np.int32)
        frec["a"], frec["b"], frec["c"] = fa[:, 0], fa[:, 1], fa[:, 2]
        out.write(frec.tobytes())
