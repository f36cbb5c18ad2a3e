"""Plain PyTorch 3D Gaussian Splatting: projection, SH colour, tile
binning and front-to-back compositing, written from the semantics the
program states (``gstk_torch/ops/projection.py``,
``gstk_torch/ops/rasterize.py``, ``gstk_torch/ops/raster_cuda.py``).

It imports nothing of the program. It recomputes from the scene's raw
parameters (log scales, logit opacities, raw quaternions, SH coefficients)
and the camera everything the program derives, and it is differentiable by
autograd end to end, so :mod:`gsbench.reference.train` takes its gradients
from it. Semantics, as stated by the program:

* EWA projection with the view-space mean clamped to 1.3 tan(fov), a 0.3 px
  blur, a 3-sigma radius from the larger eigenvalue (``b^2 - det`` clamped
  to 0.1), pixel centres through ``projmat @ viewmat`` with a 1e-6
  homogeneous epsilon and a -0.5 offset, the near plane at 0.01;
* each Gaussian covers the tiles of the bounding box (truncated, per
  horizontal band) of its visible ellipse ``sigma <= ln(255 op)`` clipped to
  the 3-sigma square;
* per pixel, the covering Gaussians front to back by depth (ties in lane
  order): alpha = min(op exp(-sigma), 0.999), entries with sigma < 0 or
  alpha < 1/255 skipped, and the first entry that would bring the
  transmittance to 1e-4 or below stops the pixel for good, unapplied;
* colours are SH of degree ``sh_degree`` + 0.5, floored at 0, with the
  view-space depth as a fourth channel; the background enters through the
  final transmittance.

Compositing runs in blocks of tiles of like length, padded to the block's
longest list, so that it fits whatever the scene. The forward walks each
block front to back in chunks and stops once every pixel has; the
backward walks each block again with its autograd graph.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from gsbench.reference.precision import Arith

BLOCK = 16  # tile side, pixels
ALPHA_CLAMP = 0.999
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
NEAR = 0.01
# pairs (tile entries x 256 pixels) per compositing block, and entries a
# step of the forward's walk
BLOCK_PAIRS = 1 << 25
CHUNK = 1024

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class View(NamedTuple):
    """One camera: OpenGL c2w (3, 4), pinhole intrinsics, image size."""

    c2w: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int


class Splats(NamedTuple):
    """Screen-space Gaussians of one view (all lanes)."""

    xys: torch.Tensor  # (N, 2)
    conics: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N,) 0 where not drawn
    colors: torch.Tensor  # (N, 4) rgb + depth
    depths: torch.Tensor  # (N,)
    radii: torch.Tensor  # (N,) float, 0 where not drawn


def _quat_rot(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) unit wxyz -> (N, 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def camera_matrices(view: View) -> Tuple[torch.Tensor, torch.Tensor]:
    """(world -> OpenCV camera (4, 4), projmat @ viewmat (4, 4))."""
    c2w = view.c2w.to(torch.float32)
    dev = c2w.device
    rot = c2w[:, :3] * torch.tensor([1.0, -1.0, -1.0], device=dev)
    rinv = rot.T
    viewmat = torch.eye(4, device=dev)
    viewmat[:3, :3] = rinv
    viewmat[:3, 3] = -(rinv @ c2w[:, 3])
    # the frustum in float32, as the program states it (projection_matrix)
    n, f = 0.001, 1000.0
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    fovx = 2.0 * torch.atan(0.5 * view.width / f32(view.fx))
    fovy = 2.0 * torch.atan(0.5 * view.height / f32(view.fy))
    r, t = n * torch.tan(0.5 * fovx), n * torch.tan(0.5 * fovy)
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    proj = torch.stack([
        torch.stack([n / r, zero, zero, zero]),
        torch.stack([zero, n / t, zero, zero]),
        torch.stack([zero, zero, (f + n) / (f - n) * one, -f * n / (f - n) * one]),
        torch.stack([zero, zero, one, zero]),
    ])
    return viewmat, proj @ viewmat


def sh_colors(degree: int, dirs: torch.Tensor, coeffs: torch.Tensor,
              ar: Arith) -> torch.Tensor:
    """SH of degree <= 3 at unit ``dirs`` (N, 3), ``coeffs`` (N, K, 3)."""
    x, y, z = dirs.unbind(-1)
    b = [torch.full_like(x, SH_C0)]
    if degree > 0:
        b += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        b += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
              SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree > 2:
        b += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
              SH_C3[2] * y * (4 * zz - xx - yy),
              SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
              SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
              SH_C3[6] * x * (xx - 3 * yy)]
    bases = torch.stack(b, -1)  # (N, k)
    return ar.einsum("nk,nkc->nc", bases, coeffs[:, :bases.shape[1]])


def project(params: Dict[str, torch.Tensor], view: View, sh_degree: int,
            ar: Arith) -> Splats:
    """Every lane of ``params`` (the scene's raw tensors and ``alive``)
    projected into ``view``; differentiable in the parameters."""
    means = params["means"]
    q = params["quats"]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    scales = torch.exp(params["scales"])
    viewmat, fullmat = camera_matrices(view)
    rot = _quat_rot(q) * scales[:, None, :]
    cov3d = ar.matmul(rot, rot.transpose(1, 2))  # (N, 3, 3)
    wmat, tvec = viewmat[:3, :3], viewmat[:3, 3]
    t = ar.matmul(means, wmat.T) + tvec
    tz = t[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    lim_x = 1.3 * 0.5 * view.width / view.fx
    lim_y = 1.3 * 0.5 * view.height / view.fy
    tx = tz * torch.clamp(t[:, 0] / tz_safe, -lim_x, lim_x)
    ty = tz * torch.clamp(t[:, 1] / tz_safe, -lim_y, lim_y)
    zeros = torch.zeros_like(tz)
    jac = torch.stack([
        view.fx / tz_safe, zeros, -view.fx * tx / (tz_safe * tz_safe),
        zeros, view.fy / tz_safe, -view.fy * ty / (tz_safe * tz_safe),
    ], -1).reshape(-1, 2, 3)
    tmat = ar.matmul(jac, wmat)  # (N, 2, 3)
    cov2d = ar.matmul(ar.matmul(tmat, cov3d), tmat.transpose(1, 2))
    a = cov2d[:, 0, 0] + 0.3
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conics = torch.stack([c * inv, -b * inv, a * inv], -1)
    half = 0.5 * (a + c)
    vmax = half + torch.sqrt(torch.clamp(half * half - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(vmax, min=0.0))).detach()
    hom = ar.matmul(torch.cat([means, torch.ones_like(means[:, :1])], -1),
                    fullmat.T)
    rw = 1.0 / (hom[:, 3] + 1e-6)
    xys = torch.stack([0.5 * view.width * hom[:, 0] * rw - 0.5 + view.cx,
                       0.5 * view.height * hom[:, 1] * rw - 0.5 + view.cy], -1)
    tiles = ((view.width + BLOCK - 1) // BLOCK, (view.height + BLOCK - 1) // BLOCK)
    lo, hi = tile_box(xys.detach(), torch.stack([radius, radius], -1), tiles, 0)
    area = (hi - lo).prod(-1)
    drawn = (area > 0) & (tz >= NEAR) & ok & params["alive"]
    cam_pos = view.c2w[:, 3].to(torch.float32)
    dirs = means.detach() - cam_pos
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-12)
    coeffs = torch.cat([params["features_dc"][:, None], params["features_rest"]], 1)
    rgb = torch.clamp(sh_colors(sh_degree, dirs, coeffs, ar) + 0.5, min=0.0)
    op = torch.sigmoid(params["opacities"][:, 0])
    d = drawn[:, None]
    return Splats(
        xys=torch.where(d, xys, 0.0),
        conics=torch.where(d, conics, 0.0),
        opacities=torch.where(drawn, op, 0.0),
        colors=torch.cat([rgb, torch.where(drawn, tz, 0.0)[:, None]], -1),
        depths=torch.where(drawn, tz, 0.0).detach(),
        radii=torch.where(drawn, radius, 0.0),
    )


def tile_box(xys, ext, tiles: Tuple[int, int], y0: int):
    """Tile bounding box [lo, hi) of centres ``xys`` (pixels) with
    half-extents ``ext`` (N, 2), in a band whose first pixel row is ``y0``
    and that is ``tiles`` = (tiles_x, tile rows) big; the band-local
    centre is truncated toward zero, as the program's binning does."""
    center = (xys - torch.tensor([0.0, float(y0)], device=xys.device)) / BLOCK
    r = ext / BLOCK
    lo = torch.trunc(center - r).to(torch.int64)
    hi = torch.trunc(center + r).to(torch.int64) + 1
    top = torch.tensor(tiles, device=xys.device)
    return (torch.minimum(torch.clamp(lo, min=0), top),
            torch.minimum(torch.clamp(hi, min=0), top))


def visible_extent(s: Splats) -> torch.Tensor:
    """(N, 2) half-extents of the visible support ``sigma <= ln(255 op)``
    clipped to the 3-sigma radius (with the program's 1e-4 relative and
    1e-3 px margins, which only ever add tiles that composite nothing);
    0 where nothing is visible."""
    con, op = s.conics.detach(), s.opacities.detach()
    cut = torch.log(torch.clamp(255.0 * op, min=1e-12))
    det = torch.clamp(con[:, 0] * con[:, 2] - con[:, 1] ** 2, min=1e-24)
    s2 = torch.clamp(2.0 * cut, min=0.0) / det
    wx = torch.sqrt(torch.clamp(s2 * con[:, 2], min=0.0)) * (1 + 1e-4) + 1e-3
    wy = torch.sqrt(torch.clamp(s2 * con[:, 0], min=0.0)) * (1 + 1e-4) + 1e-3
    seen = (s.radii > 0) & (cut >= 0)
    ext = torch.stack([torch.minimum(wx, s.radii), torch.minimum(wy, s.radii)], -1)
    return torch.where(seen[:, None], ext, 0.0)


def band_rows(height: int, bands: int) -> List[Tuple[int, int]]:
    """(first pixel row, tile rows) of each horizontal band."""
    rows = (height + BLOCK - 1) // BLOCK
    bands = max(1, min(bands, rows))
    per = -(-rows // bands)
    return [(b * per * BLOCK, min(per, rows - b * per))
            for b in range(bands) if rows - b * per > 0]


class Lists(NamedTuple):
    """Every tile's Gaussians, front to back: ``gid`` sorted by (tile,
    depth), ``start``/``count`` per tile, tile origin in pixels."""

    gid: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    origin: torch.Tensor  # (T, 2) pixel x, y of each tile's corner
    width: int
    height: int


def bin_tiles(s: Splats, view: View, bands: int = 1) -> Lists:
    """The per-tile lists of every band, concatenated band by band."""
    dev = s.xys.device
    ext = visible_extent(s)
    has = (ext[:, 0] > 0) & (ext[:, 1] > 0)
    tiles_x = (view.width + BLOCK - 1) // BLOCK
    gids, tids, depths, origins, ntiles = [], [], [], [], 0
    for y0, rows in band_rows(view.height, bands):
        lo, hi = tile_box(s.xys.detach(), ext, (tiles_x, rows), y0)
        span = hi - lo
        n = torch.where(has, span.prod(-1), 0)
        g = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
        first = torch.cumsum(n, 0) - n
        k = torch.arange(g.numel(), device=dev) - first[g]
        w = torch.clamp(span[g, 0], min=1)
        tx = lo[g, 0] + k % w
        ty = lo[g, 1] + k // w
        gids.append(g)
        tids.append(ntiles + ty * tiles_x + tx)
        depths.append(s.depths[g])
        yy, xx = torch.meshgrid(torch.arange(rows, device=dev),
                                torch.arange(tiles_x, device=dev), indexing="ij")
        origins.append(torch.stack([xx.reshape(-1) * BLOCK,
                                    y0 + yy.reshape(-1) * BLOCK], -1))
        ntiles += rows * tiles_x
    g, tid, dep = torch.cat(gids), torch.cat(tids), torch.cat(depths)
    order = torch.sort(dep, stable=True).indices
    order = order[torch.sort(tid[order], stable=True).indices]
    count = torch.bincount(tid, minlength=ntiles)
    start = torch.cumsum(count, 0) - count
    return Lists(g[order], start, count, torch.cat(origins), view.width,
                 view.height)


def blocks(lists: Lists):
    """Tile indices grouped by like list length, each group with the
    length it is padded to, at most ``BLOCK_PAIRS`` pairs a group."""
    order = torch.argsort(lists.count)
    counts = [max(c, 1) for c in lists.count[order].tolist()]
    i, n = 0, len(counts)
    while i < n:
        j = i + 1
        while j < n and (j - i + 1) * counts[j] * BLOCK * BLOCK <= BLOCK_PAIRS:
            j += 1
        yield order[i:j], counts[j - 1]
        i = j


def _to_image(vals: torch.Tensor, lists: Lists, tiles: torch.Tensor,
              out: torch.Tensor) -> None:
    """Write per-tile pixel rows ``vals (B, 256, ...)`` into ``out (H, W,
    ...)``, cropping pixels past the image."""
    dev = vals.device
    p = torch.arange(BLOCK * BLOCK, device=dev)
    org = lists.origin[tiles]
    x = org[:, 0:1] + p % BLOCK
    y = org[:, 1:2] + p // BLOCK
    inside = (x < lists.width) & (y < lists.height)
    out[y[inside], x[inside]] = vals[inside]


def composite_walk(s: Splats, lists: Lists, tiles: torch.Tensor, k: int,
                   ar: Arith, chunk: Optional[int] = None):
    """Composite ``tiles`` (B,), whose lists are at most ``k`` long: returns
    ``acc (B, 256, 4)``, ``final_t (B, 256)`` and ``pairs (B, 256)``, the
    entries each pixel needs (up to and including its stop, else all). The
    walk takes ``chunk`` entries at a time, front to back, carrying each
    pixel's transmittance, and ends once every pixel has stopped; it is
    differentiable in the splats' tensors."""
    dev = s.xys.device
    chunk = min(chunk or CHUNK, k)
    cnt = lists.count[tiles]
    start = lists.start[tiles]
    p = torch.arange(BLOCK * BLOCK, device=dev)
    org = lists.origin[tiles].to(torch.float32)
    px = org[:, 0:1] + (p % BLOCK).to(torch.float32)[None]
    py = org[:, 1:2] + (p // BLOCK).to(torch.float32)[None]
    b = tiles.numel()
    trans = torch.ones((b, BLOCK * BLOCK), device=dev)
    acc = torch.zeros((b, BLOCK * BLOCK, 4), device=dev)
    dead = torch.zeros((b, BLOCK * BLOCK), dtype=torch.bool, device=dev)
    pairs = torch.zeros((b, BLOCK * BLOCK), dtype=torch.int64, device=dev)
    ar_c = torch.arange(chunk, device=dev)
    for c0 in range(0, k, chunk):
        pos = c0 + ar_c
        live = pos[None] < cnt[:, None]  # (B, C)
        g = lists.gid[torch.where(live, start[:, None] + pos[None], 0)]
        xy, con, op = s.xys[g], s.conics[g], s.opacities[g]
        dx = xy[..., 0][:, None, :] - px[:, :, None]
        dy = xy[..., 1][:, None, :] - py[:, :, None]
        sigma = (0.5 * (con[..., 0][:, None] * dx * dx + con[..., 2][:, None] * dy * dy)
                 + con[..., 1][:, None] * dx * dy)
        alpha = torch.clamp(op[:, None] * torch.exp(-sigma), max=ALPHA_CLAMP)
        valid = (sigma >= 0) & (alpha >= ALPHA_MIN) & live[:, None] & ~dead[..., None]
        factors = 1.0 - torch.where(valid, alpha, 0.0)
        t_prev = trans[..., None] * torch.cumprod(
            torch.cat([torch.ones_like(factors[..., :1]), factors[..., :-1]], -1), -1)
        stop = valid & (t_prev * factors <= T_STOP)
        stopped = torch.cumsum(stop.to(torch.int32), -1) > 0
        keep = valid & ~stopped
        a_k = torch.where(keep, alpha, 0.0)
        acc += ar.einsum("bpk,bkc->bpc", t_prev * a_k, s.colors[g])
        trans = trans * torch.prod(1.0 - a_k, -1)
        n_live = live.sum(-1, keepdim=True).expand_as(trans)
        first = torch.where(stop.any(-1), stop.to(torch.float32).argmax(-1) + 1, n_live)
        pairs += torch.where(dead, 0, first)
        dead = dead | stop.any(-1)
        if bool(dead.all()):
            break
    return acc, trans, pairs


def composite(s: Splats, lists: Lists, ar: Arith):
    """The whole image, without an autograd graph: ``acc (H, W, 4)``,
    ``final_t (H, W)`` and the pairs needed, an int."""
    dev = s.xys.device
    h, w = lists.height, lists.width
    acc = torch.zeros((h, w, 4), device=dev)
    final_t = torch.ones((h, w), device=dev)
    pairs = 0
    with torch.no_grad():
        for tiles, k in blocks(lists):
            a, t, n = composite_walk(s, lists, tiles, k, ar)
            pairs += int(n.sum())
            _to_image(a, lists, tiles, acc)
            _to_image(t, lists, tiles, final_t)
    return acc, final_t, pairs


def _from_image(img: torch.Tensor, lists: Lists, tiles: torch.Tensor):
    """The inverse of :func:`_to_image`: per-tile pixel rows of ``img``,
    zero for pixels past the image."""
    dev = img.device
    p = torch.arange(BLOCK * BLOCK, device=dev)
    org = lists.origin[tiles]
    x = org[:, 0:1] + p % BLOCK
    y = org[:, 1:2] + p // BLOCK
    inside = (x < lists.width) & (y < lists.height)
    out = img.new_zeros(x.shape + img.shape[2:])
    out[inside] = img[y[inside], x[inside]]
    return out


def composite_backward(s: Splats, lists: Lists, g_acc: torch.Tensor,
                       g_final_t: torch.Tensor, ar: Arith) -> None:
    """Back-propagate the image cotangents ``g_acc (H, W, 4)`` and
    ``g_final_t (H, W)`` into the tensors of ``s`` (which require grad),
    one block of tiles at a time, each recomputed with its graph."""
    for tiles, k in blocks(lists):
        a, t, _ = composite_walk(s, lists, tiles, k, ar)
        loss = ((a * _from_image(g_acc, lists, tiles)).sum()
                + (t * _from_image(g_final_t, lists, tiles)).sum())
        if loss.requires_grad:
            loss.backward()


def render(params: Dict[str, torch.Tensor], view: View, sh_degree: int,
           background: torch.Tensor, bands: int, ar: Arith) -> Dict[str, torch.Tensor]:
    """A render's outputs as the program states them: ``rgb`` (H, W, 3)
    clipped at 1, ``depth`` (accumulated depth / alpha where alpha > 0, else
    the largest accumulated depth) and ``alpha`` = 1 - final T."""
    with torch.no_grad():
        s = project(params, view, sh_degree, ar)
        lists = bin_tiles(s, view, bands)
        acc, final_t, pairs = composite(s, lists, ar)
    return outputs(acc, final_t, background) | {"pairs": pairs}


def outputs(acc, final_t, background):
    """rgb, depth and alpha from the composited planes (differentiable)."""
    rgb = torch.clamp(acc[..., :3] + final_t[..., None] * background, max=1.0)
    alpha = 1.0 - final_t
    dacc = acc[..., 3]
    depth = torch.where(alpha > 0, dacc / torch.clamp(alpha, min=1e-10),
                        dacc.max().detach())
    return {"rgb": rgb, "depth": depth, "alpha": alpha}
