"""Scatter-add economics on the card (port of ``tools/bench_scatter.py``):
is a scatter-add bound by its update rows or by their bytes, and would
one multi-column scatter and per-column cumsums beat three separate
scatter + cumsum passes?

``--n`` (2^20) update rows with sorted indices in [0, cap] (``--cap``
2^20; duplicates included) and int32 values from ``default_rng(0)`` go
into a (cap + 1, k) int32 buffer. Cases:

* ``index_add_`` of k = 1, 2, 3, 4 and 8 columns, and ``scatter_add_``
  of the same (its index expanded to the k columns);
* column extraction from the (cap + 1, 3) result: three strided column
  copies, and one transpose copy;
* the fused candidate, one 3-column scatter then a cumsum of each column
  (``fused slice-cols``, ``fused transpose``, and ``fused 2d-cumsum``: one
  ``cumsum`` over the rows of the 3-column buffer), against
  ``3x(scatter+cumsum)``.

Every case is held equal to numpy (``np.add.at``, ``np.cumsum`` in int64
cast back to int32). Times are the device time of a call (every device
event, torch.profiler, ``--iters`` calls), with the bytes and the bytes
bound at 3.35 TB/s of each scatter (the indices and values read, the
buffer written once).

Usage (on the card):
  python -m gstk_torch.tools.bench_scatter [--iters 30]
CPU rehearsal (checks only, untimed):
  python -m gstk_torch.tools.bench_scatter --device cpu --n 4096 --cap 4096
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import numpy as np
import torch

from gstk_torch import resolve_device
from gstk_torch.tools import bound, card, kernel_device_ms

KS = (1, 2, 3, 4, 8)


def variants(idx: torch.Tensor, vals: torch.Tensor, cap: int
             ) -> Dict[str, Callable]:
    """name -> a call returning a tensor or a list of them."""
    long_idx = idx.long()

    def index_add(k):
        return lambda: torch.zeros((cap + 1, k), dtype=torch.int32,
                                   device=idx.device).index_add_(
                                       0, long_idx, vals[:, :k])

    def scatter_add(k):
        ix = long_idx[:, None].expand(-1, k)
        return lambda: torch.zeros((cap + 1, k), dtype=torch.int32,
                                   device=idx.device).scatter_add_(
                                       0, ix, vals[:, :k])

    cumsum = lambda x: torch.cumsum(x, 0, dtype=torch.int64).to(torch.int32)
    buf3 = index_add(3)
    out = {f"index_add_ k={k}": index_add(k) for k in KS}
    out.update({f"scatter_add_ k={k}": scatter_add(k) for k in KS})
    made = buf3()
    out["extract: 3 column copies"] = lambda: [made[:, c].contiguous()
                                               for c in range(3)]
    out["extract: 1 transpose copy"] = lambda: made.t().contiguous()
    one_column = lambda c: torch.zeros(
        cap + 1, dtype=torch.int32, device=idx.device).index_add_(
            0, long_idx, vals[:, c])
    out["3x(scatter+cumsum)"] = lambda: [cumsum(one_column(c)[:-1])
                                         for c in range(3)]
    out["fused slice-cols"] = lambda: [cumsum(b[:-1, c]) for b in [buf3()]
                                       for c in range(3)]
    out["fused transpose"] = lambda: [cumsum(bt[c]) for bt in [buf3()[:-1].t()]
                                      for c in range(3)]
    out["fused 2d-cumsum"] = lambda: cumsum(buf3()[:-1])
    return out


def reference(idx: np.ndarray, vals: np.ndarray, cap: int, name: str):
    """numpy's result of case ``name``."""
    def added(k):
        buf = np.zeros((cap + 1, k), np.int64)
        np.add.at(buf, idx, vals[:, :k])
        return buf.astype(np.int32)

    cs = lambda x: np.cumsum(x.astype(np.int64), 0).astype(np.int32)
    if name.startswith(("index_add_", "scatter_add_")):
        return added(int(name.split("=")[1]))
    b = added(3)
    if name == "extract: 3 column copies":
        return [b[:, c] for c in range(3)]
    if name == "extract: 1 transpose copy":
        return b.T
    if name == "fused 2d-cumsum":
        return cs(b[:-1])
    return [cs(b[:-1, c]) for c in range(3)]


def scatter_bytes(n: int, cap: int, k: int) -> int:
    """An index and k values read a row, the (cap + 1, k) buffer written."""
    return n * 4 * (1 + k) + (cap + 1) * k * 4


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("bench_scatter")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--n", type=int, default=1 << 20, help="update rows")
    ap.add_argument("--cap", type=int, default=1 << 20, help="buffer rows")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu checks, untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card_run = dev.type == "cuda"
    n, cap = args.n, args.cap
    rng = np.random.default_rng(0)
    # sorted, like the binning's cumulative counts (monotone, some repeats)
    idx = np.sort(rng.integers(0, cap + 1, n)).astype(np.int32)
    vals = rng.integers(-1000, 1000, (n, 8)).astype(np.int32)
    res: Dict = {"n": n, "cap": cap, "cases": {}}
    if card_run:
        res["card"] = card()
        print(res["card"], flush=True)
    cases = variants(torch.from_numpy(idx).to(dev),
                     torch.from_numpy(vals).to(dev), cap)
    for name, fn in cases.items():
        got = fn()
        got = ([g.cpu().numpy() for g in got] if isinstance(got, list)
               else got.cpu().numpy())
        want = reference(idx, vals, cap, name)
        equal = (all(np.array_equal(g, w) for g, w in zip(got, want))
                 if isinstance(want, list) else np.array_equal(got, want))
        assert equal, f"{name} differs from numpy"
        entry = {"equal": equal}
        if card_run:
            entry["ms"] = kernel_device_ms(fn, None, args.iters)["ms_per_call"]
            if "=" in name:
                nbytes = scatter_bytes(n, cap, int(name.split("=")[1]))
                entry.update(bytes=nbytes, **bound(nbytes))
                entry["bound_share"] = entry["bound_ms"] / entry["ms"]
            print(f"{name:28s}: device {entry['ms']:8.4f} ms" + (
                f", bytes bound {entry['bound_ms']:.4f} ms "
                f"({entry['bound_share']:.3f} of it)" if "=" in name else ""),
                flush=True)
        res["cases"][name] = entry
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
