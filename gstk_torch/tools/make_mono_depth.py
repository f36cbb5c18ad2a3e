"""Synthesize a mono-depth dataset variant and validate (m, c) recovery
(port of ``tools/make_mono_depth.py``; numpy on the host, no device work).

The mono-depth co-gs path (reference ``depth_gs.py:477-531`` losses +
``colmap_utils.py:513-591`` alignment) needs a dataset with per-frame
mono-depth scales. Without mono-depth weights, this tool manufactures an
honest stand-in for a mono-depth network's output from the raytraced
scene's GT depth:

  est_i(px) = a_i * z(px) + b_i + smooth low-frequency error + pixel noise

with per-image affine corruption (a_i, b_i) unknown to the pipeline. It
then rebuilds the alignment inputs the way the real pipeline would see
them — a COLMAP-style sparse model synthesized by projecting the SfM seed
cloud (sparse.ply) into each view — runs ``align_mono_depth`` verbatim to
recover per-image (m, c), converts them into training units (the
dataparser's auto-scale S enters the shift: D_train = png * 1e-3 * S and
pred is in scene units, so m_t = 255e-3 * m_fit, c_t = 255e-3 * S * c_fit),
and writes a sibling dataset directory with ``depths_mono/`` +
``transforms.json`` frames carrying "scale"/"shift" — the exact contract
``data/dataparser.py`` consumes for co-gs `use_est_depth` training.
PNGs are read and written by :mod:`gstk_torch.utils.io` (no Pillow).

Prints a recovery report (fit vs ground-truth corruption) and refuses to
write the dataset if median relative scale error exceeds 2%.

Usage: python -m gstk_torch.tools.make_mono_depth --data <raytraced dir> \
           --out <mono dir>
"""

import argparse
import json
import os
from pathlib import Path

import numpy as np

PNG_PER_UNIT = 4096.0  # mono png value per est unit (absorbed into m, c)


def _smooth_field(rng, h, w, cells=8, amp=1.0):
    """Low-frequency multiplicative error field (bilinear-upsampled grid)."""
    g = rng.normal(0, amp, (cells + 1, cells + 1))
    yy = np.linspace(0, cells, h)
    xx = np.linspace(0, cells, w)
    y0 = np.clip(yy.astype(int), 0, cells - 1)
    x0 = np.clip(xx.astype(int), 0, cells - 1)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def main(argv=None) -> dict:
    """Write the mono variant; returns the recovery report (median and max
    relative scale error, frames, the dataparser scale S)."""
    from gstk_torch.process_data.colmap import ColmapImage, ColmapPoint3D
    from gstk_torch.process_data.depth_align import align_mono_depth
    from gstk_torch.utils.io import read_ply, read_png, write_png

    ap = argparse.ArgumentParser("make-mono-depth")
    ap.add_argument("--data", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--points-per-image", type=int, default=400)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    meta = json.loads((args.data / "transforms.json").read_text())
    fx, fy = meta["fl_x"], meta["fl_y"]
    cx, cy, w, h = meta["cx"], meta["cy"], meta["w"], meta["h"]

    (args.out / "depths_mono").mkdir(parents=True, exist_ok=True)
    for link in ("images", "sparse.ply"):
        dst = args.out / link
        if not dst.exists():
            os.symlink(os.path.relpath(args.data / link, args.out), dst)

    # ---- synthesize per-image corrupted mono estimates -------------------
    truth = {}
    new_frames = []
    for i, fr in enumerate(meta["frames"]):
        depth_png = read_png(args.data / fr["depth_path"]).astype(np.float64)
        z = depth_png * 1e-3  # world-unit view z; 0 = sky
        a_i = float(rng.uniform(0.25, 0.55))
        b_i = float(rng.uniform(0.1, 0.5))
        z_eff = np.where(z > 0, z, 20.0)  # mono nets hallucinate far sky
        est = a_i * z_eff + b_i
        est *= 1.0 + 0.01 * _smooth_field(rng, *z.shape)
        est += rng.normal(0, 0.005, z.shape)
        png = np.clip(est * PNG_PER_UNIT, 0, 65535).astype(np.uint16)
        name = Path(fr["depth_path"]).name
        write_png(args.out / "depths_mono" / name, png)
        truth[fr["file_path"]] = (a_i, b_i)
        nf = dict(fr)
        nf["depth_path"] = f"depths_mono/{name}"
        new_frames.append(nf)

    # ---- synthetic COLMAP sparse model from the seed cloud ---------------
    ply = read_ply(args.data / "sparse.ply")["vertex"]
    pts = np.stack([ply["x"], ply["y"], ply["z"]], axis=-1).astype(np.float64)
    sub = pts[rng.choice(len(pts), min(len(pts), 20000), replace=False)]

    images, seen_by = {}, {j: [] for j in range(len(sub))}
    for i, fr in enumerate(meta["frames"]):
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        r_w2c = c2w[:3, :3].T
        t_w2c = -r_w2c @ c2w[:3, 3]
        pc = sub @ r_w2c.T + t_w2c  # OpenGL cam: looks along -z
        zs = -pc[:, 2]
        uu = fx * pc[:, 0] / zs + cx
        vv = -fy * pc[:, 1] / zs + cy
        vis = (zs > 0.05) & (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        # Occlusion consistency (what COLMAP's track verification gives
        # the real pipeline): keep only points whose SfM depth matches
        # the surface actually seen at that pixel — frustum-only
        # visibility pairs occluded points with the OCCLUDER's mono
        # estimate and wrecks the affine fit (measured: 26% median
        # scale error without this check, <1% with it).
        gt_z = read_png(args.data / fr["depth_path"]).astype(np.float64) * 1e-3
        zi = gt_z[
            np.clip(vv.astype(int), 0, h - 1),
            np.clip(uu.astype(int), 0, w - 1),
        ]
        vis &= (zi > 0) & (np.abs(zs - zi) < 0.02 * np.maximum(zs, 1e-6))
        idx = np.flatnonzero(vis)
        idx = rng.choice(
            idx, min(args.points_per_image, idx.size), replace=False
        )
        # COLMAP convention: camera looks along +z — hand the aligner
        # (qvec, tvec) of the OpenGL->COLMAP flipped pose so its
        # rot @ xyz + tvec z matches zs above.
        flip = np.diag([1.0, -1.0, -1.0])
        r_cv = flip @ r_w2c
        t_cv = flip @ t_w2c
        # branch-robust matrix -> quaternion (the naive trace formula
        # divides by qw, which vanishes for 180-degree rotations)
        m = r_cv
        tr = np.trace(m)
        if tr > 0:
            s = 2 * np.sqrt(1 + tr)
            qw, qx, qy, qz = (
                s / 4, (m[2, 1] - m[1, 2]) / s,
                (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s,
            )
        else:
            ax = int(np.argmax(np.diag(m)))
            bx, cx_ = (ax + 1) % 3, (ax + 2) % 3
            s = 2 * np.sqrt(max(1e-12, 1 + m[ax, ax] - m[bx, bx] - m[cx_, cx_]))
            q = np.zeros(4)
            q[1 + ax] = s / 4
            q[0] = (m[cx_, bx] - m[bx, cx_]) / s
            q[1 + bx] = (m[bx, ax] + m[ax, bx]) / s
            q[1 + cx_] = (m[cx_, ax] + m[ax, cx_]) / s
            qw, qx, qy, qz = q
        images[i] = ColmapImage(
            image_id=i,
            qvec=np.array([qw, qx, qy, qz]),
            tvec=t_cv,
            camera_id=0,
            name=Path(new_frames[i]["depth_path"]).name,
            xys=np.stack([uu[idx], vv[idx]], axis=-1),
            point3d_ids=idx.astype(np.int64),
        )
        for j in idx:
            seen_by[int(j)].append(i)

    points = {
        int(j): ColmapPoint3D(
            id=int(j), xyz=sub[j], rgb=np.zeros(3), error=0.5,
            image_ids=np.asarray(seen_by[j]),
            point2d_idxs=np.zeros(len(seen_by[j]), np.int64),
        )
        for j in range(len(sub))
        if seen_by[j]  # images reference these ids; the aligner's
        # min_n_visible filter handles the < 2-view ones itself
    }

    mono_dir = args.out / "depths_mono"

    def depth_lookup(name):
        p = mono_dir / name
        return read_png(p).astype(np.float64) if p.exists() else None

    m_fit, c_fit = align_mono_depth(images, points, depth_lookup, w, h)

    # ---- training-unit conversion (needs the dataparser's auto-scale) ----
    from gstk_torch.data.dataparser import DataparserConfig, parse_transforms

    out_parse = parse_transforms(DataparserConfig(data=args.data), "train")
    S = float(out_parse.dataparser_scale)

    errs = []
    for i, fr in enumerate(new_frames):
        if i not in m_fit:
            raise RuntimeError(f"alignment failed for frame {i}")
        m_t = 255e-3 * m_fit[i]
        c_t = 255e-3 * S * c_fit[i]
        a_i, b_i = truth[fr["file_path"]]
        m_gt = 1e-3 * PNG_PER_UNIT * a_i
        c_gt = 1e-3 * PNG_PER_UNIT * S * b_i
        errs.append(abs(m_t - m_gt) / m_gt)
        fr["scale"] = m_t
        fr["shift"] = c_t

    med = float(np.median(errs))
    print(f"mono (m, c) recovery: median rel scale error {med:.4%} over "
          f"{len(errs)} frames (max {max(errs):.4%}); dataparser S={S:.4f}")
    if med > 0.02:
        raise SystemExit("recovery too poor — refusing to write dataset")

    meta_out = dict(meta)
    meta_out["frames"] = new_frames
    with open(args.out / "transforms.json", "w") as f:
        json.dump(meta_out, f, indent=2)
    print(f"mono dataset written to {args.out}")
    return {"median_rel_scale_error": med, "max_rel_scale_error": max(errs),
            "frames": len(errs), "dataparser_scale": S}


if __name__ == "__main__":
    main()
