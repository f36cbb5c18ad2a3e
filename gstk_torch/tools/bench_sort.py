"""The sort-size cliff on the card (port of ``tools/bench_sort.py``).

gstk_tpu keeps the intersection buffer at or under 2^21 a band because
sorts past it were slow on its TPU, and the port keeps the same ceiling
(``train/trainer.py``); this tool measures whether the ceiling has any
cost reason here. It does not change it.

Cases at n = 2^18 ... 2^22 (``--logn``), each on device-resident inputs
from ``default_rng(0)``:

* ``torch.sort(stable=True)`` of an int32 or int64 key carrying 1, 2 or 4
  operands, the key counted (the payloads move by a gather on the
  permutation, as the port's binning moves its ids);
* the port's binning sort: the packed int64 key ``tile << 32 |
  depth_bits`` (``ops/binning.py``) over 2500 tiles and depths in [2, 9),
  and the gather of the Gaussian ids by its permutation.

Each case's result is held equal to numpy's (``argsort(kind="stable")``
and fancy indexing). Times are the device time of a call (every device
event, torch.profiler, ``--iters`` calls), in ms and ns an element; then
each case's per-element cost across 2^20 -> 2^21.

Usage (on the card):
  python -m gstk_torch.tools.bench_sort [--iters 20]
CPU rehearsal (checks only, untimed):
  python -m gstk_torch.tools.bench_sort --device cpu --logn 12 14
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from gstk_torch import resolve_device
from gstk_torch.tools import card, kernel_device_ms

LOGN = (18, 19, 20, 21, 22)
TILES = 2500  # 800x800 in 16x16 tiles
CLIFF = (20, 21)


def case_inputs(n: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    return {
        "i32": rng.integers(0, 1 << 31, n, dtype=np.int64).astype(np.int32),
        "i64": rng.integers(0, 1 << 62, n, dtype=np.int64),
        "payload": rng.integers(0, n, (3, n)).astype(np.int32),
        "tile": rng.integers(0, TILES, n).astype(np.int64),
        "depth": rng.uniform(2.0, 9.0, n).astype(np.float32),
    }


def packed_key(tile: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """``tile << 32 | depth_bits``: positive float32 bits sort as floats."""
    return (tile << 32) | depth.view(np.int32).astype(np.int64)


def cases(x: Dict[str, torch.Tensor]) -> Dict[str, Tuple[Callable, Callable]]:
    """name -> (the torch case, its numpy reference), each returning the
    sorted key and the carried operands."""
    def keyed(key: str, operands: int):
        def run():
            keys, perm = torch.sort(x[key], stable=True)
            return [keys] + [x["payload"][i][perm] for i in range(operands - 1)]

        def ref(a):
            perm = np.argsort(a[key], kind="stable")
            return [a[key][perm]] + [a["payload"][i][perm]
                                     for i in range(operands - 1)]
        return run, ref

    def binning():
        keys, perm = torch.sort((x["tile"] << 32) | x["depth"].view(
            torch.int32).long(), stable=True)
        return [keys, x["payload"][0][perm]]

    def binning_ref(a):
        k = packed_key(a["tile"], a["depth"])
        perm = np.argsort(k, kind="stable")
        return [k[perm], a["payload"][0][perm]]

    out = {f"{key} key, {ops} operand{'s' * (ops > 1)}": keyed(key, ops)
           for key in ("i32", "i64") for ops in (1, 2, 4)}
    out["binning: packed (tile, depth) i64 key + ids"] = (binning, binning_ref)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("bench_sort")
    ap.add_argument("--logn", type=int, nargs="+", default=list(LOGN))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu checks, untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card_run = dev.type == "cuda"
    res: Dict = {"cases": {}}
    if card_run:
        res["card"] = card()
        print(res["card"], flush=True)
    rng = np.random.default_rng(0)
    print(f"{'case':46s} {'n':>9s} {'ms':>9s} {'ns/elem':>8s}")
    for logn in args.logn:
        n = 1 << logn
        a = case_inputs(n, rng)
        x = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        for name, (run, ref) in cases(x).items():
            got = [t.cpu().numpy() for t in run()]
            want = ref(a)
            equal = all(np.array_equal(g, w) for g, w in zip(got, want))
            assert equal, f"{name} at n = {n} differs from numpy"
            entry = {"equal": equal}
            if card_run:
                t = kernel_device_ms(run, None, args.iters)
                entry.update(ms=t["ms_per_call"],
                             ns_per_elem=t["ms_per_call"] / n * 1e6)
                print(f"{name:46s} {n:9d} {entry['ms']:9.4f} "
                      f"{entry['ns_per_elem']:8.4f}", flush=True)
            res["cases"].setdefault(name, {})[logn] = entry
    if card_run and all(k in args.logn for k in CLIFF):
        res["cliff"] = {}
        for name, by_n in res["cases"].items():
            lo, hi = (by_n[k]["ns_per_elem"] for k in CLIFF)
            res["cliff"][name] = hi / lo
            print(f"2^{CLIFF[0]} -> 2^{CLIFF[1]}: {name}: {lo:.4f} -> "
                  f"{hi:.4f} ns an element (x{hi / lo:.3f})")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
