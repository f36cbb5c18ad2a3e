"""The readings that the limits of ``correct`` are set from, for one cell:

    python3 -m gsbench.control --workload <cell> --seeds <n> [<n> ...] [--seconds s]
        [--controls 0|1] [--out chiprun_out/<file>.jsonl]

For each seed, in one process: the cell's set-up (a train cell's checked
start), a window of ``--seconds`` and the driver's stretch after it (a
train cell's late stretch; a render cell's window serves the requests);
then the program's numbers against the plain reference in float32 (the
lower readings), and with ``--controls 1`` the same numbers of the
reference put in the program's place as the TF32 control and with each
planted fault (:data:`gsbench.reference.train.FAULTS`; a render cell's
halves and altered rows). One JSON line per seed, to standard output and
``--out``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

from gsbench.run import Failure, Run, load_manifest


def readings(driver, controls: bool):
    out = {}
    if hasattr(driver, "kept"):  # render: each sampled request
        from gsbench import scene as gscene

        driver._params = gscene.draw_scene(driver.cfg, driver.cap, driver.run.scene_seed,
                                           driver.device)
        names = {"program": None}
        if controls:
            names.update({"tf32": (True, ""), "half": (False, "half"),
                          "altered": (False, "altered")})
        for k in sorted(driver.kept):
            ref = driver.reference_outputs(k)
            for name, how in names.items():
                got = driver.kept[k] if how is None else driver.reference_outputs(k, *how)
                for m, v in driver.compare(got, ref).items():
                    out.setdefault(name, {})
                    out[name][m] = max(out[name].get(m, 0.0), v)
        return out
    from gsbench.drivers.train import LATE

    ref = driver.reference_readings()
    late = driver.reference_readings(late=True)
    out["program"] = driver.compare(driver.program_readings(), ref)
    out["program"].update(driver.compare(driver.program_readings(True), late, LATE))
    out.update(driver.cull_detail(late))
    if controls:
        for name, kw in (("tf32", {"tf32": True}), ("half", {"fault": "half"}),
                         ("altered", {"fault": "altered"}),
                         ("cull_none", {"fault": "cull_none"}),
                         ("cull_logit", {"fault": "cull_logit"})):
            out[name] = {}
            if not name.startswith("cull"):  # the start holds no refine
                out[name] = driver.compare(driver.reference_readings(**kw), ref)
            out[name].update(driver.compare(
                driver.reference_readings(late=True, **kw), late, LATE))
        out["reference"] = {k: v for k, v in ref.items() if k not in ("alive", "opacities")}
        out["program_detail"] = driver.program_readings()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gsbench.control: no CUDA device", file=sys.stderr)
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
                **readings(driver, bool(args.controls)),
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
        print(f"gsbench.control: {exc}", file=sys.stderr)
        sys.exit(3)
