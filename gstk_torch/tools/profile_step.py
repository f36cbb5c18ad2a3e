"""A per-op device-time table of bench.py's train step, or with
``--render`` of its render (port of ``tools/profile_step.py``).

It builds :func:`gstk_torch.tools.bench_point.bench_point` (the sizes from
``--res``, ``--n``, ``--capacity`` and ``--isect``, which default to the
``BENCH_*`` variables as the reference's do; the reference's capacity
default is 1<<17, not bench.py's 104·1024), takes two warm-up steps (the
first builds the kernels), times ``--steps`` steps on the host clock,
synchronized, and traces ``--steps`` more under ``torch.profiler``,
written as a Chrome trace (``trace_<time>.json``, with the run's numbers
in ``trace_<time>.meta.json``) under ``--trace-dir``. ``--parse-only``
re-reads the newest trace there.

It prints the steady-state step, the traced window's wall (host clock,
ending in a synchronize), the device's busy time (the union of the
device-side events: kernels, copies and fills) and its idle share, of the
traced window and of the untraced step (the profiler slows the host, so
the traced window is longer than a step), and a
table of ms / step, launches / step and name over the ``--top`` device
events by time, then one row for the rest. Only device-side events count:
the CPU ops of a trace also carry the device time of what they launched.
Then how many launches were recorded against how many were made: for
K1-K4 the wrappers' own counts against the kernels the trace holds, and
for all device work the trace's launch, copy and fill calls against the
device events matched to them by correlation id.

``--capacity 2097152 --n 250000 --isect 2097152`` profiles a step at 2^21
lanes with its intersections (printed) in one band under 2^21.

Usage (on the card):
  python -m gstk_torch.tools.profile_step [--steps 10] [--top 45] [--render]
  python -m gstk_torch.tools.profile_step --parse-only
CPU rehearsal (no device events; the trace and its parse only):
  python -m gstk_torch.tools.profile_step --device cpu --res 64 --n 2000 \\
      --capacity 2048 --isect 16384 --steps 2
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

from gstk_torch import resolve_device
from gstk_torch.tools import card, launches_during
from gstk_torch.tools.bench_point import SH_DEGREE, bench_env, bench_point, make_step

DEFAULT_TRACE_DIR = Path("traces/profile_step")
PROFILE_CAP = 1 << 17  # the reference's BENCH_CAP default
WINDOW = "profile_step.window"  # the traced window's annotation
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
CALL_WORDS = ("Launch", "Memcpy", "Memset")  # calls that put work on the device
# K1-K4's CUDA kernel names (csrc/*.cu)
KERNEL_NAMES = {"composite_tiles_fwd": "composite_fwd_kernel",
                "composite_tiles_bwd": "composite_bwd_kernel",
                "segment_broadcast": "segment_broadcast_kernel",
                "segment_sum_sorted": "segment_sum_kernel"}


def busy_us(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, duration)`` spans."""
    total, end = 0.0, float("-inf")
    for start, dur in sorted(spans):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def op_table(events: List[Dict], steps: int, top: int) -> Dict:
    """Device events (``name``, ``dur`` in us) summed by name: the ``top``
    names by time as ``[ms / step, launches / step, name]`` rows, and the
    rest as one ``other`` row ``[ms / step, names]``."""
    agg = defaultdict(lambda: [0.0, 0])
    for e in events:
        agg[e["name"]][0] += e["dur"]
        agg[e["name"]][1] += 1
    rows = sorted(([us / 1e3 / steps, n / steps, name]
                   for name, (us, n) in agg.items()), reverse=True)
    return {"rows": rows[:top],
            "other": [sum(r[0] for r in rows[top:]), len(rows[top:])]}


def parse(trace: Dict, meta: Dict, top: int) -> Dict:
    """The report of a Chrome trace of ``meta["steps"]`` steps."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    wall_us = windows[-1]["dur"] if windows else None
    steps = meta["steps"]
    calls = {e["args"]["correlation"] for e in events
             if e.get("cat") in CALL_CATEGORIES
             and any(w in e["name"] for w in CALL_WORDS)
             and "correlation" in e.get("args", {})}
    matched = sum(e.get("args", {}).get("correlation") in calls for e in device)
    busy = busy_us((e["ts"], e["dur"]) for e in device) / 1e3
    out = {"steps": steps, "device_events": len(device),
           "device_busy_ms": busy, "launch_calls": len(calls),
           "device_events_matched": matched,
           "table": op_table(device, steps, top)}
    if wall_us is not None:
        out["window_ms"] = wall_us / 1e3
        if device:
            out["idle_share"] = 1.0 - busy / out["window_ms"]
    if device and "step_ms" in meta:
        # the profiler slows the host: the untraced step is the truer wall.
        # Busy time a step beyond the untraced step means a miscount or
        # mismatched windows: the share is then negative, and says so
        out["step_idle_share"] = 1.0 - busy / steps / meta["step_ms"]
        if out["step_idle_share"] < 0:
            print(f"warning: the device is busy {busy / steps:.3f} ms a step, "
                  f"more than the untraced step's {meta['step_ms']:.3f} ms",
                  file=sys.stderr)
    made = meta.get("launches_made", {})
    out["kernels"] = {}
    for name, sym in KERNEL_NAMES.items():
        pattern = re.compile(rf"(?<!\w){sym}(?!\w)")
        out["kernels"][name] = {
            "made": made.get(name),
            "recorded": sum(bool(pattern.search(e["name"])) for e in device)}
    return out


def print_report(rep: Dict, meta: Dict) -> None:
    steps = rep["steps"]
    if "step_ms" in meta:
        print(f"steady-state {meta['what']}: {meta['step_ms']:.3f} ms (host "
              f"clock, synchronized, {steps} after 2 warm-ups; "
              f"{meta['rays_per_s'] / 1e6:.2f}M rays/s)")
    if "num_intersects" in meta:
        print(f"num_intersects {meta['num_intersects']} of capacity "
              f"{meta['isect_capacity']} (one band), {meta['n']} Gaussians "
              f"in {meta['capacity']} lanes, {meta['res']}x{meta['res']}")
    if "window_ms" in rep:
        print(f"traced window: {rep['window_ms']:.3f} ms for {steps} "
              f"({rep['window_ms'] / steps:.3f} ms / step, host clock)")
    if rep["device_events"]:
        print(f"device busy {rep['device_busy_ms']:.3f} ms "
              f"({rep['device_busy_ms'] / steps:.3f} ms / step), idle share "
              f"{rep.get('idle_share', float('nan')):.3f} of the traced "
              f"window, {rep.get('step_idle_share', float('nan')):.3f} of the "
              f"untraced step")
    else:
        print("no device events in the trace (not a card run)")
    print(f"{'ms/step':>9}  {'n/step':>6}  op")
    for ms, n, name in rep["table"]["rows"]:
        print(f"{ms:9.4f}  {n:6.1f}  {name[:110]}")
    other_ms, other_n = rep["table"]["other"]
    print(f"{other_ms:9.4f}          (other {other_n} ops)")
    print(f"launches: {rep['device_events']} device events recorded, "
          f"{rep['launch_calls']} launch / copy / fill calls recorded, "
          f"{rep['device_events_matched']} device events matched to a call")
    for name, k in rep["kernels"].items():
        print(f"  {name}: {k['made']} made (the wrapper's count), "
              f"{k['recorded']} recorded")


def newest_trace(trace_dir: Path) -> Tuple[Path, Dict]:
    traces = sorted(p for p in Path(trace_dir).glob("trace_*.json")
                    if not p.name.endswith(".meta.json"))
    if not traces:
        raise SystemExit(f"no trace under {trace_dir}")
    path = traces[-1]
    return path, json.loads(path.with_suffix(".meta.json").read_text())


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("profile_step")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=45)
    ap.add_argument("--trace-dir", type=Path, default=DEFAULT_TRACE_DIR)
    ap.add_argument("--res", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=None,
                    help=f"lanes (BENCH_CAP, else {PROFILE_CAP})")
    ap.add_argument("--isect", type=int, default=None)
    ap.add_argument("--parse-only", action="store_true",
                    help="parse the newest trace in --trace-dir")
    ap.add_argument("--render", action="store_true",
                    help="profile the render instead of the train step")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.parse_only:
        path, meta = newest_trace(args.trace_dir)
        rep = parse(json.loads(path.read_text()), meta, args.top)
        print(f"trace {path}")
        print_report(rep, meta)
        return {**meta, **rep}

    dev = resolve_device(args.device)
    cap = (bench_env("BENCH_CAP", PROFILE_CAP) if args.capacity is None
           else args.capacity)
    point = bench_point(args.res, args.n, cap, args.isect, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    meta: Dict = {"what": "render" if args.render else "step",
                  "device": str(dev), "res": point.res, "n": point.n,
                  "capacity": point.capacity,
                  "isect_capacity": point.raster.isect_capacity,
                  "steps": args.steps}
    if dev.type == "cuda":
        meta["card"] = card()
        print(meta["card"], flush=True)
    if args.render:
        from gstk_torch.models.vanilla import render_scene

        background = torch.zeros(3, device=dev)

        def run_once():
            with torch.no_grad():
                return render_scene(point.scene, point.camera, point.res,
                                    point.res, sh_degree=SH_DEGREE,
                                    background=background,
                                    raster_config=point.raster)
    else:
        from gstk_torch.train.step import init_train_state

        step_fn = make_step(point)
        state = init_train_state(point.scene)

        def run_once():
            nonlocal state
            state, metrics = step_fn(state, point.camera, point.gt)
            return metrics

    for _ in range(2):
        out = run_once()
    sync()
    meta["num_intersects"] = int(out["num_intersects"])
    t0 = time.perf_counter()
    for _ in range(args.steps):
        run_once()
    sync()
    meta["step_ms"] = (time.perf_counter() - t0) / args.steps * 1e3
    meta["rays_per_s"] = point.res * point.res / meta["step_ms"] * 1e3

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=activities)

    def traced():
        with prof, torch.profiler.record_function(WINDOW):
            for _ in range(args.steps):
                run_once()
            sync()
    meta["launches_made"] = launches_during(traced)
    args.trace_dir.mkdir(parents=True, exist_ok=True)
    path = args.trace_dir / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    path.with_suffix(".meta.json").write_text(json.dumps(meta, indent=1))
    rep = parse(json.loads(path.read_text()), meta, args.top)
    print(f"trace {path}")
    print_report(rep, meta)
    return {**meta, **rep}


if __name__ == "__main__":
    main()
