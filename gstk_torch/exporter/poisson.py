"""Grid-based screened-Poisson surface reconstruction and mesh cleanup
(port of ``gstk_tpu/exporter/poisson.py``).

The second meshing backend of ``gs-export offline-tsdf``. The
reconstruction is formulated on the regular TSDF grid
(:mod:`gstk_torch.exporter.tsdf`):

  1. the normal field is the TSDF gradient restricted to the narrow band
     (|tsdf| < band), normalized and confidence-weighted;
  2. the indicator chi solves the screened Poisson equation
     (lap - lam*W) chi = div(v) - lam*W*chi0, where chi0 is the clamped
     TSDF: the screening term anchors chi to the observed surface;
  3. Jacobi iterations with a 7-point stencil (``torch.roll``, on the
     device; one Python loop step a sweep);
  4. the isosurface chi = 0 is extracted with marching tetrahedra.

``clean_mesh`` drops small connected components and optionally
Laplacian-smooths (numpy, on the host).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.exporter.tsdf import marching_tetrahedra


def _laplacian(x: torch.Tensor) -> torch.Tensor:
    return (
        torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
        + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
        + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)
        - 6.0 * x
    )


def _gradient(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Central difference along ``axis`` (periodic, as ``roll`` is)."""
    return (torch.roll(x, -1, axis) - torch.roll(x, 1, axis)) * 0.5


def poisson_indicator(
    tsdf: np.ndarray,
    weights: Optional[np.ndarray] = None,
    band: float = 1.0,
    screen: float = 4.0,
    iters: int = 200,
    device: DeviceLike = None,
) -> np.ndarray:
    """Solve for the indicator chi on the TSDF grid on ``device`` (default
    ``cuda``); chi < 0 inside.

    ``tsdf`` is in truncation units (clamped to [-1, 1]); ``weights`` are
    integration confidences (None -> observed = |tsdf| < 1)."""
    device = resolve_device(device)
    t = torch.as_tensor(np.asarray(tsdf), dtype=torch.float32, device=device)
    if weights is None:
        w_obs = (t.abs() < 0.999).to(torch.float32)
    else:
        w_obs = torch.clamp(torch.as_tensor(
            np.asarray(weights), dtype=torch.float32, device=device), 0.0, 1.0)

    # oriented normal field on the narrow band
    gx, gy, gz = (_gradient(t, a) for a in range(3))
    nrm = torch.sqrt(gx * gx + gy * gy + gz * gz)
    in_band = (t.abs() < band) & (nrm > 1e-6) & (w_obs > 0)
    scale = torch.where(in_band, 1.0 / torch.clamp(nrm, min=1e-6), 0.0)
    vx, vy, vz = gx * scale, gy * scale, gz * scale

    rhs = _gradient(vx, 0) + _gradient(vy, 1) + _gradient(vz, 2)  # divergence
    chi0 = torch.clamp(t, -1.0, 1.0)
    lam_w = screen * w_obs
    anchor = lam_w * chi0
    denom = 6.0 + lam_w
    chi = chi0
    for _ in range(iters):
        # Jacobi update of (lap - lam W) chi = rhs - lam W chi0
        neighbor_sum = _laplacian(chi) + 6.0 * chi
        chi = (neighbor_sum - rhs + anchor) / denom
    return chi.cpu().numpy()


def poisson_mesh(
    tsdf: np.ndarray,
    weights: np.ndarray,
    colors: np.ndarray,
    origin: np.ndarray,
    voxel_size: float,
    iters: int = 200,
    screen: float = 4.0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Extract a mesh via the screened-Poisson indicator (normals from the
    TSDF gradient field), solved on ``device``. Returns what
    marching_tetrahedra returns."""
    w = np.asarray(weights)
    chi = poisson_indicator(
        np.asarray(tsdf), np.minimum(w, 1.0), iters=iters, screen=screen,
        device=device,
    )
    # reuse the tetrahedral extractor on the indicator: mask unobserved
    # space to positive (outside) so no surface is hallucinated there
    chi = np.where(w > 0, chi, 1.0).astype(np.float32)
    return marching_tetrahedra(
        chi, w, np.asarray(colors), origin=np.asarray(origin),
        voxel_size=voxel_size,
    )


def clean_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
    min_component_frac: float = 0.05,
    smooth_iters: int = 0,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """pymeshlab-analog cleanup (reference exporter.py:288-310): drop
    connected components smaller than ``min_component_frac`` of the largest
    and optionally Laplacian-smooth."""
    if len(faces) == 0:
        return verts, faces, colors
    # union-find over face-shared vertices
    parent = np.arange(len(verts))

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(i) for i in range(len(verts))])
    labels, counts = np.unique(roots, return_counts=True)
    keep_roots = set(labels[counts >= min_component_frac * counts.max()])
    keep_v = np.array([r in keep_roots for r in roots])
    if not keep_v.all():
        remap = -np.ones(len(verts), np.int64)
        remap[keep_v] = np.arange(int(keep_v.sum()))
        keep_f = keep_v[faces].all(axis=1)
        faces = remap[faces[keep_f]]
        verts = verts[keep_v]
        if colors is not None:
            colors = colors[keep_v]

    for _ in range(smooth_iters):
        acc = np.zeros_like(verts)
        cnt = np.zeros(len(verts))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(acc, faces[:, a], verts[faces[:, b]])
            np.add.at(acc, faces[:, b], verts[faces[:, a]])
            np.add.at(cnt, faces[:, a], 1)
            np.add.at(cnt, faces[:, b], 1)
        mask = cnt > 0
        verts = verts.copy()
        verts[mask] = 0.5 * verts[mask] + 0.5 * (
            acc[mask] / cnt[mask, None]
        )
    return verts, faces, colors
