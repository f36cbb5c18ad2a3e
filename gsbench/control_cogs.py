"""The readings that the limits of ``correct`` are set from, for a cell
whose driver keeps its own (``readings(controls)``; the co-gs cell):

    python3 -m gsbench.control_cogs --workload <cell> --seeds <n> [<n> ...]
        [--seconds s] [--controls 0|1] [--out <file>.jsonl]

For each seed, in one process, as :mod:`gsbench.control` does: the cell's
set-up, a window of ``--seconds`` and the stretch after it, then the
driver's readings: the program against the plain reference in float32
(the lower readings) and, with ``--controls 1``, the reference in the
program's place as the TF32 control and with each of its planted faults.
One JSON line per seed, to standard output and ``--out``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

from gsbench.run import Failure, Run, load_manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gsbench.control_cogs")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gsbench.control_cogs: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path.cwd()
    manifest = load_manifest(root)
    cell = next(w for w in manifest["workloads"] if w["name"] == args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = Run(root, manifest, cell, seed, device)
        driver = importlib.import_module(
            f"gsbench.drivers.{run.traffic['driver']}").DRIVER(run)
        driver.setup()
        driver.window(args.seconds)
        driver.check_stretch()
        driver.release()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                **driver.readings(bool(args.controls)),
                "counts": {k: driver.counts.get(k) for k in
                           ("steps", "refine_alive_before", "refine_filled",
                            "refine_written", "step_wraps", "start", "end")},
                "seconds": time.perf_counter() - t0}
        del driver
        torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"gsbench.control_cogs: {exc}", file=sys.stderr)
        sys.exit(3)
