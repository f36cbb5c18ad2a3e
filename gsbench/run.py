"""Run one cell of the benchmark once and print its result line.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
its configuration (``gsbench/configs/<name>.json``, via the manifest) and
its traffic (``gsbench/traffic/<name>.json``), whose ``driver`` is the
general loop that runs it (:mod:`gsbench.drivers`); the limits of its
comparison are ``gsbench/limits/<cell>.json`` and each per-layer metric is
read by ``gsbench/metrics/<metric>.py``. Nothing here names a cell.

A run makes the cell's inputs from the seed on the card, sets up and warms
up the program (``setup_s``: from the process's start to the first timed
step or request), measures for ``--seconds``, and with ``--trace 1`` then
traces a short stretch for the per-layer metrics. After the window it
reads the device's peak memory, runs the driver's stretch of compared
steps (a train cell's late stretch), frees the program's state, and
compares what the timed path produced with the plain reference; each number
compared is printed beside its limit, last on standard error and last in
the result line. It exits non-zero, printing no result, without a card
(or fewer than the cell asks for), when the trace lost events, or when a
module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import heapq  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gstk_tpu")
F32_PEAK = 67e12  # H100 SXM, float32 outside the tensor cores
HBM_PEAK = 3.35e12  # bytes/s
NAME_CHARS = 200  # the breakdown keeps the start of each name


class Failure(Exception):
    """A run that must print no result."""


class Run:
    """What one run knows: its cell, configuration, traffic, seed and
    device, and where the benchmark's files are."""

    def __init__(self, root: Path, manifest: Dict, cell: Dict, seed: int, device):
        self.root = root
        self.manifest = manifest
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        cfg = next(c for c in manifest["configs"] if c["name"] == cell["config"])
        self.config = json.loads((root / cfg["file"]).read_text())
        self.traffic = json.loads(
            (root / "gsbench" / "traffic" / f"{cell['traffic']}.json").read_text())
        self.scene_seed = self.derived_seed(0)

    def derived_seed(self, k: int) -> int:
        """A 63-bit seed for stream ``k`` of this run's seed."""
        return int(np.random.SeedSequence([self.seed % (1 << 64), k])
                   .generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_manifest(root: Path) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Failure(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def _metric_reader(root: Path, name: str):
    path = root / "gsbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gsbench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card() -> Dict:
    out = {}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["nvidia_smi"] = r.stdout.strip().splitlines()[0] if r.stdout else ""
    except (OSError, subprocess.SubprocessError):
        out["nvidia_smi"] = "unavailable"
    return out


def _forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What the per-layer metric readers read: the trace, the work of the
    traced steps or requests (:mod:`gsbench.work`, counted on demand), the
    untraced time of one, and the peaks."""

    f32_peak = F32_PEAK
    hbm_peak = HBM_PEAK

    def __init__(self, info: Dict):
        self.trace = info["trace"]
        self.iterations = info["iterations"]
        self.step_ms = info["step_ms"]
        self.refine_every = info.get("refine_every")
        self._inputs = info["inputs"]
        self._sh = info["sh_degree"]
        self._passes = None

    def passes(self):
        if self._passes is None:
            from gsbench import work

            self._passes = [work.analyse(p, v, self._sh, b) for v, p, b in self._inputs]
        return self._passes

    def work(self, name: str) -> List[Dict]:
        mod = importlib.import_module(f"gsbench.work.{name}")
        return [mod.count(p) for p in self.passes()]

    def least_seconds(self, name: str) -> float:
        return sum(max(w["flops"] / F32_PEAK, w["bytes"] / HBM_PEAK)
                   for w in self.work(name))


def breakdown(trace) -> Dict:
    """The ten device operations that took most time, and the ten longest
    idle stretches of the device summed by the host operation running at
    their start, in seconds (names cut to their first 200 characters)."""
    by_name: Dict[str, float] = {}
    for e in trace.device:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"]) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace.device)
    gaps, end = [], None
    for s, t in ivs:
        if end is not None and s > end:
            gaps.append((end, s))
        end = t if end is None else max(end, t)
    # the innermost host op holding each gap's start: a sweep over the ops
    # by start, the active ones in a heap by end
    cpu = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in trace.cpu_ops)
    labels: Dict[str, float] = {}
    active: List = []
    i = 0
    for s, t in gaps:
        while i < len(cpu) and cpu[i][0] <= s:
            heapq.heappush(active, (cpu[i][1], -cpu[i][0], cpu[i][2]))
            i += 1
        while active and active[0][0] < s:
            heapq.heappop(active)
        label = (max(active, key=lambda a: -a[1])[2] if active
                 else "(host outside any op)")
        labels[label] = labels.get(label, 0.0) + (t - s) / 1e6
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}


def run(argv: Optional[List[str]] = None, root: Optional[Path] = None,
        allow_cpu: bool = False) -> Dict:
    """One run; returns the result line's object (raises :class:`Failure`
    where no result may be printed). ``allow_cpu`` is for the harness's
    own tests, which drive a run on the CPU at a tiny size."""
    ap = argparse.ArgumentParser("gsbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd() if root is None else Path(root)
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        raise Failure(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    # every build and kernel cache of the program stays in the checkout
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))

    t_imported = time.perf_counter()
    import torch

    if not allow_cpu:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Failure(f"{torch.cuda.device_count()} CUDA devices, the cell "
                          f"asks for {cell['chips']}")
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    # the configuration's precision: float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"

    r = Run(root, manifest, cell, args.seed, device)
    driver = importlib.import_module(f"gsbench.drivers.{r.traffic['driver']}").DRIVER(r)
    t_torch = time.perf_counter()
    if on_card:
        torch.zeros(1, device=device)
    t_context = time.perf_counter()
    driver.setup()
    r.sync()
    # the dataset a checkout's first run renders and caches (the train
    # targets) is the data a user's run loads, not its set-up: it is left
    # out and reported under counts.setup_parts.dataset_made_s
    setup_s = (time.perf_counter() - PROCESS_START
               - float(getattr(driver, "dataset_made_s", 0.0)))
    if on_card:
        # the peak of the measured window, not of the inputs' making
        torch.cuda.reset_peak_memory_stats(device)
    e2e = driver.window(float(args.seconds))
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e["setup_s"] = setup_s

    result: Dict = {"correct": False, "attempted": int(driver.counts.get(
        "steps", driver.counts.get("requests", 0))), "failed": 0}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    ends = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {m["name"]: m for m in manifest["per_layer"]}
    here = lambda m: args.workload in m.get("workloads", [args.workload])
    if args.trace:
        from gsbench import trace as gtrace

        info = driver.traced(lambda body: gtrace.record(body, device))
        tr = info["trace"]
        lost = gtrace.check(tr, on_card)
        if lost:
            raise Failure("the trace lost events: " + "; ".join(lost))
        ctx = Context(info)
        metrics = {}
        for name, m in layers.items():
            if not here(m):
                continue
            value = _metric_reader(root, name)(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_us() / 1e6
        device_info["window_s"] = tr.window_us() / 1e6
        result["breakdown"] = breakdown(tr)
        del info, ctx, tr
    else:
        metrics = {name: {"value": float(e2e[name]), "unit": m["unit"]}
                   for name, m in ends.items() if here(m) and name in e2e}
    result["metrics"] = metrics
    result["device"] = device_info
    result["counts"] = dict(driver.counts, setup_parts={
        "interpreter_s": t_imported - PROCESS_START,
        "torch_import_s": t_torch - t_imported,
        "cuda_context_s": t_context - t_torch,
        "driver_setup_s": setup_s - (t_context - PROCESS_START),
        **getattr(driver, "setup_parts", {})})
    if on_card:
        result["card"] = _card()

    # the steps compared after the window: the same loop, run on
    driver.check_stretch()
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    verdict = driver.verify()
    result["counts"]["compared"] = verdict["detail"]
    limits = json.loads((root / "gsbench" / "limits" / f"{args.workload}.json").read_text())
    checks = {}
    ok = True
    for name, value in verdict["numbers"].items():
        limit = limits.get(name)
        passed = limit is not None and np.isfinite(value) and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    missing = [n for n in limits if n not in verdict["numbers"]]
    ok = ok and not missing and verdict["attempted"] > 0
    result["correct"] = bool(ok)
    result["checks"] = checks
    found = _forbidden_modules()
    if found:
        raise Failure(f"modules of JAX or of the JAX package are loaded: {found}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    try:
        result = run(argv)
    except Failure as exc:
        print(f"gsbench: {exc}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
