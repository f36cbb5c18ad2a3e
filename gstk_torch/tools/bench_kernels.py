"""K1 ``composite_tiles_fwd`` and K2 ``composite_tiles_bwd`` alone at
``tools/bench_kernels.py``'s point (port of that tool).

The scene is :func:`gstk_torch.tools.bench_point.kernels_scene` (the
reference's numpy draws bit for bit: 100,000 live Gaussians of 2^17 lanes,
800x800, 4 channels, an intersection buffer of 2^20). Projection, binning
(the 3-sigma squares, as the reference bins) and the kernels' packed
records are built once; K1 then composites, and K2 differentiates with
cotangents of ones, as the reference's ``ct = ones_like(packed)``. Each is
held against its plain twin (K1 rtol 1e-3 / atol 1e-4, K2 rtol 5e-3 /
atol 1e-4 of each column's largest magnitude, as ``chip_smoke.py``'s
phases 5 and 9 hold them), timed with
:func:`gstk_torch.tools.kernel_device_ms` (torch.profiler's device time a
launch) and by CUDA events around the wrapper, and printed beside its
bound: the bytes it must move and the f32 operations its pairs need at
the H100's peaks (``chip_smoke.py``'s count, PERF.md §6).

``--sweep`` measures fixed against marginal cost: synthetic tiles of one
huge low-opacity splat per entry centred on its tile (every entry
composites, no pixel stops early), with the entries a tile holds E in
{128, ..., 2048} and the tiles T = 2^18 / E, fitting time = T X + T E Y
(X a tile's fixed cost, Y an entry's). The reference's sweep runs over
chunks of 128 entries a tile: that is a TPU layout parameter the port's
kernels do not have, so the axis here is the entries a tile holds.

Usage (on the card):
  python -m gstk_torch.tools.bench_kernels [--iters 10] [--sweep]
CPU rehearsal (plain twins, no timing) at a small size:
  python -m gstk_torch.tools.bench_kernels --device cpu --res 64 --isect 16384
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from gstk_torch import resolve_device
from gstk_torch._build import takes_kernels
from gstk_torch.ops.binning import bin_gaussians
from gstk_torch.ops.projection import project_gaussians
from gstk_torch.ops.raster_cuda import (
    composite_tiles_bwd,
    composite_tiles_bwd_plain,
    composite_tiles_fwd,
    composite_tiles_fwd_plain,
    pack_records,
)
from gstk_torch.tools import (
    bound,
    card,
    event_ms,
    k1_work,
    k2_work,
    kernel_device_ms,
)
from gstk_torch.tools.bench_point import FOCAL, K_ISECT, K_RES, kernels_scene

K1_TOL = dict(rtol=1e-3, atol=1e-4)
K2_RTOL, K2_ATOL_SHARE = 5e-3, 1e-4
# a few in a million K2 values may fall outside where the kernel's
# sequential T and the twin's cumprod round to opposite sides of the 1e-4
# stop under a final_t cotangent (chip_smoke.py phase 9)
K2_MAX_OUTSIDE = 1e-5
SWEEP_ENTRIES = (128, 256, 512, 1024, 2048)
SWEEP_TOTAL = 2048 * 128


def outside(got, want, rtol, atol) -> int:
    """Values of ``got`` outside ``atol + rtol |want|``."""
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def kernel_inputs(arrays: Dict[str, np.ndarray], res: int,
                  isect_capacity: int, device) -> Dict:
    """Project and bin ``arrays`` (:func:`kernels_scene`'s) on ``device``
    at ``res`` x ``res`` as the reference does (its square footprints),
    and pack the records: K1's arguments ``args`` and ``records``."""
    t = {k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
         for k in ("pts", "scales", "quats", "op", "colors", "viewmat",
                   "fullmat")}
    proj = project_gaussians(t["pts"], t["scales"], 1.0, t["quats"],
                             t["viewmat"], t["fullmat"], FOCAL, FOCAL,
                             res / 2, res / 2, res, res)
    tiles = ((res + 15) // 16, (res + 15) // 16)
    isect = bin_gaussians(proj.xys, proj.depths, proj.radii,
                          proj.num_tiles_hit, tiles, 16, isect_capacity)
    args = (proj.xys, proj.conics, t["op"], t["colors"], isect.gaussian_ids,
            isect.tile_bins, tiles)
    return {"args": args, "records": pack_records(*args[:4]),
            "num_intersects": int(isect.num_intersects)}


def run_kernels(inputs: Dict) -> Dict:
    """K1 and K2 through their wrappers and their plain twins at
    ``inputs``: the outputs, errors, pairs and each kernel's work (on CPU
    tensors the twins' outputs stand in for the kernels')."""
    args, rec = inputs["args"], inputs["records"]
    tiles = args[6]
    kernels = takes_kernels(args[0].device, "auto")
    acc_p, final_t_p, visited = composite_tiles_fwd_plain(*args)
    acc, final_t = (composite_tiles_fwd(*args, records=rec) if kernels
                    else (acc_p, final_t_p))
    cts = (torch.ones_like(acc), torch.ones_like(final_t))
    bwd_args = args[:6] + (acc, final_t) + cts + (tiles,)
    gout_p, kept = composite_tiles_bwd_plain(*bwd_args)
    gout = (composite_tiles_bwd(*bwd_args, records=rec) if kernels
            else gout_p)
    scale = gout_p.abs().amax(0, keepdim=True)
    ch = args[3].shape[1]
    num_tiles = tiles[0] * tiles[1]
    n_isect = min(inputs["num_intersects"], args[4].shape[0])
    pairs, kept_pairs = int(visited.sum()), int(kept.sum())
    return {
        "acc": acc, "final_t": final_t, "gout": gout,
        "num_intersects": inputs["num_intersects"], "pairs": pairs,
        "kept_pairs": kept_pairs,
        "k1_max_abs_err": max(float((acc - acc_p).abs().max()),
                              float((final_t - final_t_p).abs().max())),
        "k1_outside": (outside(acc, acc_p, **K1_TOL)
                       + outside(final_t, final_t_p, **K1_TOL)),
        "k2_max_abs_err": float((gout - gout_p).abs().max()),
        "k2_outside": outside(gout, gout_p, K2_RTOL, K2_ATOL_SHARE * scale),
        "k2_values": gout.numel(),
        "k1_work": k1_work(n_isect, num_tiles, ch, pairs),
        "k2_work": k2_work(args[4].shape[0], n_isect, num_tiles, ch, pairs,
                           kept_pairs),
    }


def sweep_inputs(entries: int, device) -> Dict:
    """The sweep's synthetic tiles: ``SWEEP_TOTAL / entries`` tiles in one
    row, ``entries`` Gaussians each, every one a huge splat centred on its
    tile at opacity 0.004, just over the 1/255 cutoff (T reaches the 1e-4
    stop only after about 2300 entries, past the largest tile here)."""
    tiles_n = SWEEP_TOTAL // entries
    rng = np.random.default_rng(0)
    tile_of = np.arange(SWEEP_TOTAL) // entries
    xys = np.stack([tile_of * 16 + 8.0, np.full(SWEEP_TOTAL, 8.0)], 1)
    conics = np.tile(np.array([1e-4, 0.0, 1e-4]), (SWEEP_TOTAL, 1))
    op = np.full(SWEEP_TOTAL, 0.004)
    colors = rng.uniform(0, 1, (SWEEP_TOTAL, 4))
    bins = np.stack([np.arange(tiles_n) * entries,
                     (np.arange(tiles_n) + 1) * entries], -1)
    f = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt, device=device)
    args = (f(xys), f(conics), f(op), f(colors),
            f(np.arange(SWEEP_TOTAL), torch.int32), f(bins, torch.int32),
            (tiles_n, 1))
    return {"args": args, "records": pack_records(*args[:4]),
            "num_intersects": SWEEP_TOTAL}


def sweep(device, iters: int) -> Dict:
    rows = []
    for entries in SWEEP_ENTRIES:
        inputs = sweep_inputs(entries, device)
        args, rec = inputs["args"], inputs["records"]
        acc, final_t = composite_tiles_fwd(*args, records=rec)
        bwd_args = args[:6] + (acc, final_t, torch.ones_like(acc),
                               torch.ones_like(final_t), args[6])
        f_ms = kernel_device_ms(
            lambda: composite_tiles_fwd(*args, records=rec),
            "composite_fwd_kernel", iters)["ms"]
        b_ms = kernel_device_ms(
            lambda: composite_tiles_bwd(*bwd_args, records=rec),
            "composite_bwd_kernel", iters)["ms"]
        acc_sum = float(acc[..., :3].abs().sum())
        tiles_n = args[6][0]
        print(f"T={tiles_n:5d} E={entries:5d}: fwd {f_ms:8.4f} ms, bwd "
              f"{b_ms:8.4f} ms (|acc| {acc_sum:.3e}, must be > 0)", flush=True)
        assert acc_sum > 0
        rows.append((tiles_n, entries, f_ms, b_ms))
    a = np.array([[t, t * e] for t, e, _, _ in rows], np.float64)
    fit = {}
    for name, col in (("fwd", 2), ("bwd", 3)):
        y = np.array([r[col] for r in rows]) * 1e3  # us
        (x_fix, y_marg), *_ = np.linalg.lstsq(a, y, rcond=None)
        fit[name] = {"tile_fixed_us": float(x_fix),
                     "entry_marginal_us": float(y_marg)}
        print(f"{name}: per-tile fixed {x_fix:.4f} us, per-entry marginal "
              f"{y_marg:.6f} us")
    return {"rows": rows, "fit": fit}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("bench_kernels")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="fixed-vs-marginal cost over tiles and entries a tile")
    ap.add_argument("--res", type=int, default=K_RES)
    ap.add_argument("--isect", type=int, default=K_ISECT)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "twins, untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card_run = dev.type == "cuda"
    res: Dict = {"res": args.res, "isect_capacity": args.isect}
    if card_run:
        res["card"] = card()
        print(res["card"], flush=True)
    if args.sweep:
        if not card_run:
            raise SystemExit("--sweep times the kernels: it runs on the card")
        res["sweep"] = sweep(dev, max(args.iters, 50))
        print(json.dumps(res))
        return res
    inputs = kernel_inputs(kernels_scene(args.res), args.res, args.isect, dev)
    out = run_kernels(inputs)
    res.update({k: v for k, v in out.items()
                if k not in ("acc", "final_t", "gout")})
    print(f"num_intersects {out['num_intersects']} of {args.isect}; "
          f"{out['pairs']} pairs evaluated, {out['kept_pairs']} kept; K1 max "
          f"abs err {out['k1_max_abs_err']:.3g} ({out['k1_outside']} outside), "
          f"K2 {out['k2_max_abs_err']:.3g} ({out['k2_outside']} of "
          f"{out['k2_values']} outside)", flush=True)
    if card_run:
        a, rec = inputs["args"], inputs["records"]
        bwd_args = a[:6] + (out["acc"], out["final_t"],
                            torch.ones_like(out["acc"]),
                            torch.ones_like(out["final_t"]), a[6])
        for name, sym, fn, work in (
            ("composite_tiles_fwd", "composite_fwd_kernel",
             lambda: composite_tiles_fwd(*a, records=rec), out["k1_work"]),
            ("composite_tiles_bwd", "composite_bwd_kernel",
             lambda: composite_tiles_bwd(*bwd_args, records=rec),
             out["k2_work"]),
        ):
            t = kernel_device_ms(fn, sym, args.iters)
            b = bound(*work)
            res[name] = {**t, "wrapper_ms": event_ms(fn, args.iters), **b,
                         "bytes": work[0], "operations": work[1]}
            print(f"{name}: {t['ms']:.4f} ms a launch (profiler, "
                  f"{t['profiler_launches']} recorded of {args.iters}), "
                  f"wrapper {res[name]['wrapper_ms']:.4f} ms (CUDA events); "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
                  f"{t['ms'] / b['bound_ms']:.1f}x it", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
