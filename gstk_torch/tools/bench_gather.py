"""Row-gather economics on the card: one module with two commands, the
ports of ``tools/bench_gather_geometry.py`` (``geometry``) and
``tools/bench_gather_locality.py`` (``locality``).

``geometry``: 2^20 row indices gathered by ``index_select`` from tables
of 2^17 ... 2^20 rows at 128 f32 columns, of 2^20 rows at 16, 32 and 64
columns, in bf16 and int8 (and bf16 at 2^17 rows), uniform, and with
monotonic (non-decreasing, expansion-style) indices at 2^20 and 2^18
rows; or, given row counts, those tables at 128 f32 columns. A smaller
``--n-out`` scales every table with it.

``locality``: 2^20 indices into a 2^20-row table, drawn uniformly or
within a window of 2^13 ... 2^20 rows sliding along the table, gathered
as rows of an (N, 128) f32 table and as columns of a (16, N) one.

``port``: the gather the port's train step runs before K4
(``ops/rasterize.py``: ``gout.index_select(0, positions)``), at bench.py's
point (:func:`gstk_torch.tools.bench_point.bench_point`; ``--res``,
``--n``, ``--capacity``, ``--isect``): K2's rows, one per slot of the
intersection buffer and ``6 + 4`` f32 wide (RGB and depth), gathered by
the int32 ``positions`` that one step of the port computes, caught as
``expansion_positions`` returns them. Beside it, at the same shape, the
same positions as int64, uniform indices as int32 and int64, and the
identity; and the geometry command's ``--n-out`` (2^20) x 16 f32 uniform
case with int32 indices (that command's indices are int64). They tell the index's
type, its order and the table's shape apart.

Each case is held equal to numpy's fancy indexing. Times are the device
time of a call (every device event, torch.profiler, ``--iters`` calls;
the kernels recorded are kept by name);
each is printed with ns a gathered row and its share of the bytes bound
at 3.35 TB/s: the distinct rows (or columns) read once, the indices read
and the output written.

Usage (on the card):
  python -m gstk_torch.tools.bench_gather geometry [ROWS ...]
  python -m gstk_torch.tools.bench_gather locality
  python -m gstk_torch.tools.bench_gather port
CPU rehearsal (checks only, untimed, small tables):
  python -m gstk_torch.tools.bench_gather geometry --device cpu --n-out 4096
  python -m gstk_torch.tools.bench_gather port --device cpu --res 64 \
      --n 2000 --capacity 2048 --isect 16384
"""

from __future__ import annotations

import argparse
import importlib
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from gstk_torch import resolve_device
from gstk_torch.tools import bound, card, kernel_device_ms
from gstk_torch.tools.bench_point import bench_point, make_step

N_OUT = 1 << 20
PORT_WIDTH = 6 + 4  # K2's row: 6 geometry gradients, RGB and depth
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def geometry_cases(rows: List[int], n_out: int
                   ) -> List[Tuple[int, int, str, str]]:
    """(table rows, width, dtype, index pattern) of each case: ``rows`` at
    128 f32 columns, else the reference's cases, whose largest table has
    ``n_out`` rows (2^20)."""
    if rows:
        return [(r, 128, "float32", "uniform") for r in rows]
    top = n_out.bit_length() - 1
    cases = [(1 << lg, 128, "float32", "uniform")
             for lg in range(top - 3, top + 1)]
    cases += [(1 << top, w, "float32", "uniform") for w in (16, 32, 64)]
    cases += [(1 << top, 128, "bfloat16", "uniform"),
              (1 << top, 128, "int8", "uniform"),
              (1 << (top - 3), 128, "bfloat16", "uniform"),
              (1 << top, 128, "float32", "monotonic"),
              (1 << (top - 2), 128, "float32", "monotonic")]
    return cases


def windowed(rng, n_out: int, n_tab: int, width: int) -> np.ndarray:
    """Indices sliding through the table in a window of ``width``: output
    position i reads near (i / n_out) n_tab +- width / 2."""
    base = (np.arange(n_out, dtype=np.int64) * n_tab) // n_out
    jitter = rng.integers(0, width, n_out)
    return ((base + jitter - width // 2) % n_tab).astype(np.int32)


def gather_case(table: np.ndarray, idx: np.ndarray, dtype: str, axis: int,
                dev, iters: int, card_run: bool,
                index_dtype: torch.dtype = torch.int64) -> Dict:
    """Gather ``idx`` (as ``index_dtype``) along ``axis`` of ``table``
    (cast to ``dtype``) on ``dev``, check it against numpy and time it on
    the card."""
    tab = torch.from_numpy(table).to(dev).to(DTYPES[dtype])
    ix = torch.from_numpy(idx).to(dev).to(index_dtype)
    fn = lambda: tab.index_select(axis, ix)
    want = np.take(tab.cpu().float().numpy(), idx, axis=axis)
    got = fn().cpu().float().numpy()
    assert np.array_equal(got, want), "the gather differs from numpy"
    entry = {"equal": True}
    if card_run:
        item = tab.element_size()
        line = tab.shape[1 - axis] * item  # bytes a row (or column)
        distinct = int(torch.unique(ix).numel())
        nbytes = (distinct * line + ix.numel() * ix.element_size()
                  + ix.numel() * line)
        t = kernel_device_ms(fn, None, iters, names=True)
        ms = t["ms_per_call"]
        entry.update(ms=ms, ns_per_row=ms * 1e6 / ix.numel(), bytes=nbytes,
                     distinct=distinct, kernels=t["names"], **bound(nbytes))
        entry["bound_share"] = entry["bound_ms"] / ms
    return entry


def geometry(args, dev, card_run: bool) -> Dict:
    rng = np.random.default_rng(0)
    out = {}
    print(f"{'rows':>9s} {'w':>4s} {'dtype':>9s} {'MB':>7s} {'idx':>10s} "
          f"{'ms':>8s} {'ns/row':>7s} {'bound':>6s}")
    for n_tab, width, dtype, pattern in geometry_cases(args.rows, args.n_out):
        if pattern == "uniform":
            idx = rng.integers(0, n_tab, args.n_out).astype(np.int32)
        else:
            idx = ((np.arange(args.n_out, dtype=np.int64) * n_tab)
                   // args.n_out).astype(np.int32)
        table = (rng.standard_normal((n_tab, width)) * 10).astype(np.float32)
        e = gather_case(table, idx, dtype, 0, dev, args.iters, card_run)
        mb = n_tab * width * torch.empty((), dtype=DTYPES[dtype]).element_size() / 1e6
        key = f"{n_tab} x {width} {dtype} {pattern}"
        out[key] = {"rows": n_tab, "width": width, "dtype": dtype,
                    "pattern": pattern, "table_mb": mb, **e}
        if card_run:
            print(f"{n_tab:9d} {width:4d} {dtype:>9s} {mb:7.0f} {pattern:>10s} "
                  f"{e['ms']:8.4f} {e['ns_per_row']:7.3f} "
                  f"{e['bound_share']:6.3f}", flush=True)
    return out


def locality(args, dev, card_run: bool) -> Dict:
    rng = np.random.default_rng(0)
    n_out = n_tab = args.n_out
    cases = {"uniform": rng.integers(0, n_tab, n_out).astype(np.int32)}
    for lg in (13, 15, 17, 19, 20):
        if (1 << lg) <= n_tab:
            cases[f"window 2^{lg}"] = windowed(rng, n_out, n_tab, 1 << lg)
    wide = rng.standard_normal((n_tab, 128), dtype=np.float32)
    cols = rng.standard_normal((16, n_tab), dtype=np.float32)
    out = {}
    print(f"{'pattern':16s} {'row (N,128) ms':>15s} {'col (16,N) ms':>15s}")
    for name, idx in cases.items():
        row = gather_case(wide, idx, "float32", 0, dev, args.iters, card_run)
        col = gather_case(cols, idx, "float32", 1, dev, args.iters, card_run)
        out[name] = {"row": row, "col": col}
        if card_run:
            print(f"{name:16s} {row['ms']:15.4f} {col['ms']:15.4f} (bound "
                  f"share {row['bound_share']:.3f} / {col['bound_share']:.3f})",
                  flush=True)
    return out


def port_positions(point) -> torch.Tensor:
    """The ``positions`` one train step of the port at ``point`` gathers
    K2's rows with, caught as ``ops/rasterize.py`` computes them."""
    from gstk_torch.train.step import init_train_state

    # the module, not the function ``gstk_torch.ops`` exports by its name
    rasterize = importlib.import_module("gstk_torch.ops.rasterize")

    real, caught = rasterize.expansion_positions, []

    def catch(isect):
        caught.append(real(isect))
        return caught[-1]

    rasterize.expansion_positions = catch
    try:
        make_step(point)(init_train_state(point.scene), point.camera, point.gt)
    finally:
        rasterize.expansion_positions = real
    assert len(caught) == 1, f"{len(caught)} bands: one expected"
    return caught[0]


def port(args, dev, card_run: bool) -> Dict:
    point = bench_point(args.res, args.n, args.capacity, args.isect, dev)
    positions = port_positions(point).cpu().numpy()
    rows = positions.shape[0]
    rng = np.random.default_rng(0)
    gout = rng.standard_normal((rows, PORT_WIDTH), dtype=np.float32)
    uniform = rng.integers(0, rows, rows).astype(np.int32)
    n_geo = args.n_out
    geo_idx = rng.integers(0, n_geo, n_geo).astype(np.int32)
    geo_tab = rng.standard_normal((n_geo, 16), dtype=np.float32)
    cases = {
        "port positions int32": (gout, positions, torch.int32),
        "port positions int64": (gout, positions, torch.int64),
        "uniform int32": (gout, uniform, torch.int32),
        "uniform int64": (gout, uniform, torch.int64),
        "identity int32": (gout, np.arange(rows, dtype=np.int32), torch.int32),
        f"geometry {n_geo} x 16 uniform int32": (geo_tab, geo_idx,
                                                 torch.int32),
    }
    out = {}
    print(f"the port's gather: {rows} rows of {PORT_WIDTH} f32 at "
          f"{point.res}x{point.res}, {point.n} Gaussians")
    print(f"{'case':34s} {'ms':>8s} {'ns/row':>7s} {'bound':>6s}")
    for name, (table, idx, index_dtype) in cases.items():
        e = gather_case(table, idx, "float32", 0, dev, args.iters, card_run,
                        index_dtype)
        out[name] = {"rows": table.shape[0], "width": table.shape[1],
                     "indices": idx.shape[0], **e}
        if card_run:
            print(f"{name:34s} {e['ms']:8.4f} {e['ns_per_row']:7.3f} "
                  f"{e['bound_share']:6.3f}", flush=True)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("bench_gather")
    ap.add_argument("command", choices=("geometry", "locality", "port"))
    ap.add_argument("rows", type=int, nargs="*",
                    help="geometry: these table rows at 128 f32 columns")
    ap.add_argument("--n-out", type=int, default=N_OUT,
                    help="indices gathered (locality: also the table rows)")
    ap.add_argument("--iters", type=int, default=20)
    for size in ("--res", "--n", "--capacity", "--isect"):
        ap.add_argument(size, type=int, default=None,
                        help="port: bench.py's point's size (BENCH_*)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu checks, untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card_run = dev.type == "cuda"
    res: Dict = {"command": args.command, "n_out": args.n_out}
    if card_run:
        res["card"] = card()
        print(res["card"], flush=True)
    res["cases"] = {"geometry": geometry, "locality": locality,
                    "port": port}[args.command](args, dev, card_run)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
