"""The reference's quality workflow end to end, and its report: a capture
of the raytraced scene (``--capture``: the band-limited ``ss3`` one of
:mod:`gstk_torch.tools.gen_raytraced_sharded`, or the ``1spp`` one of
:mod:`gstk_torch.data.raytraced`), with ``--mono`` its mono-depth variant
(:mod:`gstk_torch.tools.make_mono_depth`), the recipe
(:mod:`gstk_torch.tools.run_quality`) in resumed stretches of 7500 steps
(the recipe's ``--steps-per-eval-all-images``), gs-eval after each, the
trainer's summary (:mod:`gstk_torch.tools.summarize_run`), the per-ring
table, the ceiling analysis (:mod:`gstk_torch.tools.analyze_gt_aliasing`
and :mod:`gstk_torch.tools.eval_vs_supersampled`) and one counted train
step from the final checkpoint (K1-K4 launches a step at the run's last
band count). With ``--published`` the report sets the reference's gs-eval
JSON beside the final result (PSNR, SSIM, the per-ring means and the
lowest view, and the difference of each) and, where the reference's docs
give it, its eval curve beside each stretch's gs-eval.

Each of the reference's published runs is one command (flags after ``--``
go to gs-train after the recipe's):

  =============================  ==========================================
  ``eval_240_ss3.json``          (the defaults)
  ``eval_240.json``              ``--capture 1spp``
  ``eval_240_cogs.json``         ``--capture 1spp --method co-gs``
  ``eval_240_aa.json``           ``--capture 1spp -- --model.rasterize-mode
                                 antialiased``
  ``eval_240_mono_cogs.json``    ``--capture 1spp --mono`` (co-gs with the
                                 four mono flags of
                                 ``docs/RESULTS_240_MONO.md``)
  ``eval_240_30k.json``          ``--capture 1spp --iters 30000 --
                                 --max-capacity 2097152``
                                 (``docs/RESULTS_240_30K.md``)
  ``eval_240_ss3_30k.json``      ``--iters 30000``: the 15k recipe to 15k,
                                 then that checkpoint resumed with
                                 ``--max-capacity 2097152
                                 --model.stop-split-at 25000`` to 30k
                                 (``docs/RESULTS_240_FOLLOWUPS.md`` (c))
  =============================  ==========================================

The ss 3 30k run is the reference's continuation: its stretches past 15k
add :data:`SS3_CONTINUATION` after the recipe's flags (the later flag
wins), as the reference resumed its 15k checkpoint.

The capture's directory is named as the reference named it
(``raytraced240``, ``raytraced240_ss3``, ``raytraced240_mono``), so the run's
``experiment_name`` is the reference's; the final gs-eval is copied to
``eval_<cfg>_torch.json``, ``<cfg>`` the reference's name for the run
(``_30k`` for a run past 15k steps). Each configuration trains in its own
``runs_<cfg>``, so a 30k run never resumes a 15k run's checkpoint, and a
rehearsal in ``runs_<cfg>_stretch<n>``; a capture is reused only if it
was made with the same arguments.

Everything goes under ``--work-dir``; what a report needs (the gs-eval
JSONs, ``metrics.jsonl``, the trainer's log, ``report.md`` and
``quality.json``, whose last copy is also printed) under ``--out-dir``.
A call cut short is picked up by the same command: it keeps the capture,
resumes the run from its newest checkpoint, keeps the gs-eval of every
stretch an earlier call finished, appends to ``train.log``, and the
report says which call ran each stretch.

The ceiling analysis compares the views' 1-spp GT with a 3x3 supersampled
render, so it is the ceiling of the ``1spp`` capture's own GT; on the
``ss3`` capture it bounds a 1-spp capture of the same views, not the GT
this run trained on, and the report says which.

Usage (on the card):
  python -m gstk_torch.tools.quality_workflow --capture 1spp \\
      --published eval_240.json --out-dir runs/quality/report
CPU rehearsal at a small size (a ``--stretch`` that divides 7500 stands
for the recipe's 7500 steps, so ``--iters 80 --stretch 20`` rehearses a
30k configuration and its continuation starts at step 40):
  python -m gstk_torch.tools.quality_workflow --device cpu --n-views 24 \\
      --width 64 --height 64 --seed-points 2000 --iters 40 \\
      --stretch 20 -- --isect-capacity 16384
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from gstk_torch.tools import run_quality
from gstk_torch.tools.gen_raytraced_sharded import generate_sharded_dataset

EVAL_INTERVAL = 8  # the recipe's eval split
STRETCH = 7500  # the recipe's --steps-per-eval-all-images
RECIPE_ITERS = 15000
# docs/RESULTS_240_FOLLOWUPS.md (c): the ss 3 30k run resumed the 15k
# checkpoint with twice the capacity and the split window reopened
SS3_CONTINUATION = ["--max-capacity", "2097152",
                    "--model.stop-split-at", "25000"]
# the reference's eval curves, {step: (PSNR, SSIM or None)}, where its docs
# give them (its JSONs hold the final step only)
PUBLISHED_CURVES = {
    # docs/RESULTS_240_FOLLOWUPS.md (b)
    "eval_240_ss3.json": {7500: (26.161, 0.9371), 15000: (26.339, 0.9413)},
    # docs/RESULTS_240_30K.md, "Eval curve"
    "eval_240_30k.json": {7500: (22.809, 0.9083), 15000: (22.785, 0.9117),
                          22500: (22.894, 0.9136), 30000: (22.873, 0.9132)},
    # FOLLOWUPS (b) to 15k, then (c): "peak 26.461 @22.5k"
    "eval_240_ss3_30k.json": {7500: (26.161, 0.9371),
                              15000: (26.339, 0.9413),
                              22500: (26.461, None),
                              30000: (26.331, 0.9414)},
}
GROWTH = re.compile(r"^step (\d+): (.*)$")
CAPTURES = {"ss3": 3, "1spp": 1}  # rays per pixel axis
CEILING_SS = 3  # analyze_gt_aliasing's supersampling
# docs/RESULTS_240_MONO.md: co-gs on the mono dataset
MONO_FLAGS = ["--model.use-est-depth", "True",
              "--model.use-pearson-depth", "True",
              "--model.use-scaled-est-depth", "True",
              "--model.use-depth-regularization", "True"]


def data_name(capture: str, mono: bool) -> str:
    """The capture's directory, as the reference named it."""
    return ("raytraced240" + ("_ss3" if capture == "ss3" else "")
            + ("_mono" if mono else ""))


def rasterize_mode(flags: List[str]) -> str:
    """The ``--model.rasterize-mode`` gs-train takes from ``flags`` (the
    last one wins), ``classic`` without one."""
    mode = "classic"
    for i, a in enumerate(flags):
        if a == "--model.rasterize-mode" and i + 1 < len(flags):
            mode = flags[i + 1]
        elif a.startswith("--model.rasterize-mode="):
            mode = a.split("=", 1)[1]
    return mode


def stretch_ends(iters: int, stretch: int = STRETCH) -> List[int]:
    """The step each stretch of a run of ``iters`` steps ends at: every
    ``stretch`` steps, and ``iters``."""
    return list(range(stretch, iters, stretch)) + [iters]


def step_scale(stretch: int) -> int:
    """How many of the recipe's steps one step of the run stands for: 1,
    or in a rehearsal, whose stretches are shorter than the recipe's 7500
    steps, 7500 / ``stretch`` (a whole number). The run's name, its
    published curve and the ss 3 continuation all read the recipe's step
    through this one number."""
    if stretch >= STRETCH:
        return 1
    if STRETCH % stretch:
        raise ValueError(f"--stretch {stretch}: a rehearsal's stretch "
                         f"divides the recipe's {STRETCH}")
    return STRETCH // stretch


def continuation_start(capture: str, iters: int,
                       stretch: int = STRETCH) -> Optional[int]:
    """The step of the ss 3 15k checkpoint that the run's later stretches
    resume with :data:`SS3_CONTINUATION` (the recipe's step 15000), or
    None (a run of at most 15k recipe steps, or the 1-spp capture).
    Raises unless a stretch ends at that step."""
    scale = step_scale(stretch)
    if capture != "ss3" or iters * scale <= RECIPE_ITERS:
        return None
    start = RECIPE_ITERS // scale
    if start not in stretch_ends(iters, stretch):
        raise ValueError(
            f"the ss 3 continuation resumes the checkpoint of step {start}, "
            f"which no stretch of {stretch} steps to {iters} ends at")
    return start


def config_name(capture: str, method: str, mono: bool,
                flags: List[str], length: int = RECIPE_ITERS) -> str:
    """The reference's name of the run, ``eval_<name>.json``:
    ``240[_ss3][_aa][_mono][_cogs][_30k]``, the last for a run longer than
    the 15k recipe (``length`` at the recipe's scale)."""
    return ("240" + ("_ss3" if capture == "ss3" else "")
            + ("_aa" if rasterize_mode(flags) == "antialiased" else "")
            + ("_mono" if mono else "")
            + ("" if method == "gaussian-splatting"
               else "_" + method.replace("-", ""))
            + (f"_{length / 1000:g}k" if length > RECIPE_ITERS else ""))


def add_config_args(ap: argparse.ArgumentParser) -> None:
    """The options that pick one of the reference's configurations."""
    ap.add_argument("--capture", choices=sorted(CAPTURES), default="ss3")
    ap.add_argument("--mono", action="store_true",
                    help="train co-gs on the capture's mono-depth variant")
    ap.add_argument("--method", default=None,
                    help="gaussian-splatting (co-gs with --mono)")
    ap.add_argument("--published", type=Path, default=None,
                    help="the reference's gs-eval JSON of this configuration")
    ap.add_argument("--iters", type=int, default=RECIPE_ITERS)
    ap.add_argument("--stretch", "--first-stretch", type=int, default=STRETCH,
                    help="steps a stretch (the recipe's 7500)")


def resolve_config(ap: argparse.ArgumentParser, args,
                   extra: List[str]) -> tuple:
    """(method, gs-train flags after the recipe's, the reference's name of
    the run) of :func:`add_config_args`' options; ``--mono`` puts its four
    flags before ``extra``."""
    method = args.method or ("co-gs" if args.mono else "gaussian-splatting")
    if args.mono and method != "co-gs":
        ap.error("--mono trains co-gs")
    extra = (list(MONO_FLAGS) if args.mono else []) + list(extra)
    try:
        continuation_start(args.capture, args.iters, args.stretch)
        length = args.iters * step_scale(args.stretch)
    except ValueError as e:
        ap.error(str(e))
    return method, extra, config_name(args.capture, method, args.mono, extra,
                                      length)


def runs_name(cfg_name: str, stretch: int) -> str:
    """The directory the run trains in: ``runs_<cfg>``, and for a
    rehearsal ``runs_<cfg>_stretch<n>``, so that a full-size run never
    resumes a rehearsal's checkpoint."""
    return f"runs_{cfg_name}" + (
        "" if step_scale(stretch) == 1 else f"_stretch{stretch}")


def stretch_flags(args, extra: List[str]) -> List[List[str]]:
    """gs-train's flags after the recipe's for each stretch: ``extra``, and
    past the ss 3 15k checkpoint :data:`SS3_CONTINUATION` after them."""
    start = continuation_start(args.capture, args.iters, args.stretch)
    return [list(extra) + (SS3_CONTINUATION
                           if start is not None and end > start else [])
            for end in stretch_ends(args.iters, args.stretch)]


def published_curve(path: Path, step: int) -> Optional[tuple]:
    """The reference's (PSNR, SSIM or None) at ``step`` of the run whose
    gs-eval JSON is ``path``, where its docs give it."""
    return PUBLISHED_CURVES.get(Path(path).name, {}).get(step)


def prepare_data(work_dir: Path, capture: str, mono: bool, n_views: int,
                 img_wh, seed_points: int, device=None,
                 reuse: bool = False) -> tuple:
    """Write the capture (and with ``mono`` its mono-depth variant) under
    ``work_dir``, and its arguments beside it (``<name>.capture.json``);
    with ``reuse`` a directory that already holds ``transforms.json`` is
    kept if it was written with these arguments, and refused otherwise.
    Returns the dataset to train on and what was done: seconds of each
    step that ran, the mono tool's report."""
    from gstk_torch.data.raytraced import generate_raytraced_dataset
    from gstk_torch.tools import make_mono_depth

    data = Path(work_dir) / data_name(capture, False)
    done: Dict = {"capture": capture}
    made_with = {"n_views": n_views, "img_wh": list(img_wh),
                 "seed_points": seed_points, "rays_per_axis": CAPTURES[capture]}
    record = data.with_name(data.name + ".capture.json")
    if reuse and (data / "transforms.json").exists():
        kept = (json.loads(record.read_text()) if record.exists()
                else "not recorded")
        if kept != made_with:
            raise SystemExit(
                f"{data} holds a capture made with {kept}, not {made_with};"
                " remove it or choose another --work-dir")
    else:
        t0 = time.perf_counter()
        if capture == "ss3":
            generate_sharded_dataset(data, n_views, img_wh, seed_points,
                                     CAPTURES[capture], device=device)
        else:
            generate_raytraced_dataset(data, n_views, img_wh, seed_points,
                                       supersample=CAPTURES[capture],
                                       device=device)
        done["capture_s"] = time.perf_counter() - t0
        record.write_text(json.dumps(made_with))
        print(f"capture {capture}: {n_views} views at {img_wh[0]}x{img_wh[1]}"
              f" in {done['capture_s']:.1f} s", flush=True)
    if not mono:
        return data, done
    mono_dir = Path(work_dir) / data_name(capture, True)
    if not (reuse and (mono_dir / "transforms.json").exists()):
        t0 = time.perf_counter()
        done["mono"] = make_mono_depth.main(["--data", str(data), "--out",
                                             str(mono_dir)])
        done["mono_s"] = time.perf_counter() - t0
    return mono_dir, done


def published_diff(ours: dict, path: Path) -> dict:
    """The reference's gs-eval JSON ``path`` beside ``ours`` (``psnr``,
    ``ssim`` and :func:`rings` of the per-view PSNR): its numbers and
    ours minus its. A JSON without per-view numbers has no rings."""
    ref = json.loads(Path(path).read_text())
    res = ref["results"]
    out = {"file": Path(path).name, "experiment_name": ref.get("experiment_name"),
           "method_name": ref.get("method_name"),
           "checkpoint": ref.get("checkpoint"),
           "psnr": res["psnr"], "ssim": res["ssim"],
           "d_psnr": ours["psnr"] - res["psnr"],
           "d_ssim": ours["ssim"] - res["ssim"]}
    per = ref.get("per_image", {}).get("psnr")
    if not per:
        out["rings"] = "not published (the JSON holds no per-view PSNR)"
        return out
    r = rings(per)
    out.update(ring_means=r["ring_means"], min_view=r["min_view"],
               min_view_index=r["min_view_index"],
               d_ring_means=[a - b for a, b in zip(ours["ring_means"],
                                                    r["ring_means"])],
               d_min_view=ours["min_view"] - r["min_view"])
    return out


def published_line(diff: dict) -> str:
    """One printed line of :func:`published_diff`."""
    line = (f"vs {diff['file']}: PSNR {diff['psnr']:.3f} ({diff['d_psnr']:+.3f})"
            f", SSIM {diff['ssim']:.4f} ({diff['d_ssim']:+.4f})")
    if "ring_means" in diff:
        line += (", rings " + " / ".join(f"{m:.2f} ({d:+.2f})" for m, d in zip(
            diff["ring_means"], diff["d_ring_means"]))
            + f", lowest view {diff['min_view']:.2f} ({diff['d_min_view']:+.2f})")
    return line


def _python_m(module: str, argv: List[str], log: Optional[Path] = None) -> int:
    """``python -m module argv`` with the package importable; its output
    appended to ``log`` when given."""
    env = run_quality.child_env()
    cmd = [sys.executable, "-m", module, *argv]
    if log is None:
        return subprocess.call(cmd, env=env)
    with open(log, "a") as f:
        return subprocess.call(cmd, env=env, stdout=f,
                               stderr=subprocess.STDOUT)


def lane_spans(events: List, start: int) -> List:
    """(first step, lanes) spans from the capacity growths."""
    spans = [(0, start)]
    for step, msg in events:
        m = re.match(r"Growing Gaussian capacity (\d+) -> (\d+)", msg)
        if m:
            spans.append((step + 1, int(m.group(2))))
    return spans


def iter_ms_by_lanes(rows: List[Dict], spans: List) -> Dict[int, dict]:
    """Median ``ITER_TRAIN_TIME`` (ms) of the log windows at each capacity,
    the windows that hold a growth or a stretch's first steps left out."""
    train = [r for r in rows if "Train Iter (time)" in r]
    firsts = {train[0]["step"]}
    firsts |= {b["step"] for a, b in zip(train, train[1:])
               if b["step"] <= a["step"]}  # a resumed stretch restarts
    out = {}
    for k, (s0, lanes) in enumerate(spans):
        s1 = spans[k + 1][0] if k + 1 < len(spans) else float("inf")
        ms = [r["Train Iter (time)"] * 1e3 for r in train
              if s0 + 10 <= r["step"] < s1 and r["step"] not in firsts]
        if ms:
            out[lanes] = {"median_ms": statistics.median(ms),
                          "min_ms": min(ms), "max_ms": max(ms),
                          "windows": len(ms), "steps": [s0, min(s1, train[-1]["step"] + 1)]}
    return out


def growth_counts(events: List) -> Dict[str, int]:
    """How many growth events of each kind the trainer logged: Gaussian
    capacity, intersection buffer, band split, band merge."""
    kinds = {"lanes": "Growing Gaussian capacity",
             "isect": "Growing intersection capacity",
             "band_split": "splitting into", "band_merge": "merging to"}
    return {k: sum(v in msg for _, msg in events) for k, v in kinds.items()}


def peak_by_lanes(text: str) -> Dict[int, float]:
    """The device peak (MiB) at each Gaussian capacity over every gs-train
    of the log (the most where several trained at one capacity)."""
    out: Dict[int, float] = {}
    for group in re.findall(r"\(by lanes: ([^)]*)\)", text):
        for lanes, mib in re.findall(r"(\d+): ([0-9.]+)", group):
            out[int(lanes)] = max(float(mib), out.get(int(lanes), 0.0))
    return out


def alive_summary(rows: List[Dict]) -> dict:
    """The alive count of the run's metrics rows: its peak, the first
    step at the peak, and the count logged nearest each 1000th step."""
    alive = [(r["step"], int(r["num_alive"])) for r in rows
             if "num_alive" in r]
    peak = max(a for _, a in alive)
    return {"peak": peak,
            "peak_step": next(s for s, a in alive if a == peak),
            "every_1000": {k: min(alive, key=lambda x: abs(x[0] - k))[1]
                           for k in range(0, alive[-1][0] + 1, 1000)}}


def rings(per_view: List[float]) -> dict:
    """Mean PSNR of each ring (frame index mod 3) and the lowest view."""
    arr = np.asarray(per_view, np.float64)
    ring = (np.arange(len(arr)) * EVAL_INTERVAL) % 3
    return {"ring_means": [float(arr[ring == r].mean()) for r in range(3)],
            "min_view": float(arr.min()), "min_view_index": int(arr.argmin()),
            "mean": float(arr.mean())}


def counted_steps(argv: List[str], steps: int) -> dict:
    """Train ``steps`` steps in this process from the run's last
    checkpoint (``argv`` resumes it), the evals off, and count K1-K4."""
    from gstk_torch.ops import raster_cuda, segment_kernel
    from gstk_torch.scripts.train import main as train_main
    from gstk_torch.train.trainer import Trainer

    wrappers = (raster_cuda.composite_tiles_fwd,
                raster_cuda.composite_tiles_bwd,
                segment_kernel.segment_broadcast,
                segment_kernel.segment_sum_sorted)
    for f in wrappers:
        f.launches = 0
    eval_all = Trainer.eval_all
    Trainer.eval_all = lambda self, step: {}
    try:
        trainer = train_main(argv)
    finally:
        Trainer.eval_all = eval_all
    return {"steps": steps, "bands": trainer.raster_cfg.bands,
            "isect_capacity": trainer.raster_cfg.isect_capacity,
            "capacity": trainer.state.scene.capacity,
            "launches": {f.__name__: f.launches for f in wrappers}}


def main(argv=None) -> dict:
    argv, extra = run_quality.split_extra(argv)
    ap = argparse.ArgumentParser("quality_workflow")
    ap.add_argument("--work-dir", type=Path, default=Path("runs/quality"))
    ap.add_argument("--out-dir", type=Path, default=Path("runs/quality/report"))
    add_config_args(ap)
    ap.add_argument("--n-views", type=int, default=240)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--seed-points", type=int, default=160_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    method, extra, cfg_name = resolve_config(ap, args, extra)
    t_start = time.perf_counter()
    dev = [] if args.device is None else ["--device", args.device]
    out = args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    # this call's number, kept beside the run's checkpoints: a call cut
    # short is picked up by the next one
    runs = args.work_dir / runs_name(cfg_name, args.stretch)
    runs.mkdir(parents=True, exist_ok=True)
    calls_json = runs / "calls.json"
    calls = json.loads(calls_json.read_text()) if calls_json.exists() else []
    calls.append({"started": time.strftime("%Y-%m-%d %H:%M:%S")})
    calls_json.write_text(json.dumps(calls, indent=1))
    call = len(calls)
    log = out / "train.log"
    with open(log, "a") as f:
        f.write(f"=== quality_workflow call {call} ===\n")
    report: Dict = {"config": cfg_name, "method": method,
                    "capture": args.capture, "mono": args.mono,
                    "extra_flags": extra, "calls": calls}
    if args.device in (None, "cuda"):
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        print(report["card"], flush=True)

    data, report["data"] = prepare_data(
        args.work_dir, args.capture, args.mono, args.n_views,
        (args.width, args.height), args.seed_points, args.device, reuse=True)

    run_dir = run_quality.run_dir(data, runs, method)
    cfg = run_dir / "config.yml"
    train = lambda a: _python_m("gstk_torch.scripts.train", a, log)
    # the stretches earlier calls finished (their gs-eval written)
    done_json = runs / "stretches.json"
    done = {s["iters"]: s for s in (json.loads(done_json.read_text())
                                    if done_json.exists() else [])}
    stretches, evals = [], {}
    for iters, flags in zip(stretch_ends(args.iters, args.stretch),
                            stretch_flags(args, extra)):
        eval_json = out / f"eval_{iters}.json"
        if (iters in done and eval_json.exists()
                and run_quality.checkpoint_step(run_dir) >= iters):
            stretches.append(done[iters])
            evals[iters] = json.loads(eval_json.read_text())
            print(f"stretch to step {iters}: done in call "
                  f"{done[iters]['call']}", flush=True)
            continue
        t0 = time.perf_counter()
        rc = run_quality.main(
            [str(data), str(runs), method, str(iters), *dev, "--",
             *flags], train=train)
        wall = time.perf_counter() - t0
        if rc:
            raise SystemExit(f"gs-train failed (rc {rc}); see {log}")
        print(f"stretch to step {iters}: {wall:.1f} s", flush=True)
        t0 = time.perf_counter()
        if _python_m("gstk_torch.scripts.eval", [
                "--load-config", str(cfg), "--output-path", str(eval_json),
                "--skip-lpips", *dev]):
            raise SystemExit("gs-eval failed")
        evals[iters] = json.loads(eval_json.read_text())
        stretches.append({"iters": iters, "wall_s": wall, "call": call,
                          "flags": flags,
                          "gs_eval_s": time.perf_counter() - t0})
        done[iters] = stretches[-1]
        done_json.write_text(json.dumps(list(done.values()), indent=1))
    report["stretches"] = stretches
    final = stretches[-1]["iters"]
    shutil.copy(run_dir / "metrics.jsonl", out / "metrics.jsonl")
    rows = [json.loads(l) for l in (run_dir / "metrics.jsonl").open()
            if l.strip()]

    # gs-eval against the trainer's own final eval (gs-train's eval_all
    # after the last step), and the per-ring table
    report["evals"] = {}
    for st in stretches:
        iters = st["iters"]
        trained = [r for r in rows if "eval_psnr" in r and r["step"] == iters]
        res = evals[iters]["results"]
        entry = {"psnr": res["psnr"], "ssim": res["ssim"],
                 "gs_eval_s": st["gs_eval_s"], "call": st["call"],
                 **rings(evals[iters]["per_image"]["psnr"])}
        if trained:
            entry["trainer_psnr"] = trained[-1]["eval_psnr"]
            entry["trainer_ssim"] = trained[-1]["eval_ssim"]
            entry["bit_for_bit"] = (res["psnr"] == trained[-1]["eval_psnr"]
                                    and res["ssim"] == trained[-1]["eval_ssim"])
        ref = (published_curve(args.published,
                               iters * step_scale(args.stretch))
               if args.published is not None else None)
        if ref is not None:
            entry["published_psnr"], entry["published_ssim"] = ref
            entry["d_published_psnr"] = res["psnr"] - ref[0]
            print(f"step {iters}: PSNR {res['psnr']:.3f}, the reference "
                  f"{ref[0]:.3f} ({entry['d_published_psnr']:+.3f})",
                  flush=True)
        report["evals"][iters] = entry
    result_json = out / f"eval_{cfg_name}_torch.json"
    shutil.copy(out / f"eval_{final}.json", result_json)
    if args.published is not None:
        report["published"] = published_diff(report["evals"][final],
                                             args.published)
        print(published_line(report["published"]), flush=True)

    text = log.read_text()
    events = [(int(m.group(1)), m.group(2)) for m in
              (GROWTH.match(l) for l in text.splitlines()) if m]
    report["growth_events"] = events
    report["growth_counts"] = growth_counts(events)
    report["device_peak_mib"] = [float(x) for x in re.findall(
        r"Device peak ([0-9.]+) MiB", text)]
    report["device_peak_by_lanes"] = peak_by_lanes(text)
    report["train_done"] = re.findall(r"Training done in ([0-9.]+) min", text)
    n_seed = rows[0]["num_alive"]
    start_lanes = run_quality.start_capacity(int(n_seed))
    report["iter_ms_by_lanes"] = iter_ms_by_lanes(
        rows, lane_spans(events, start_lanes))
    alive = [r for r in rows if "num_alive" in r]
    report["alive_end"] = alive[-1]["num_alive"]
    report["alive"] = alive_summary(rows)
    report["num_intersects_max"] = max(r.get("num_intersects", 0) for r in rows)

    # one counted stretch of 2 steps from the final checkpoint
    probe = args.work_dir / "probe"
    shutil.rmtree(probe, ignore_errors=True)
    report["counted"] = counted_steps(
        [*dev, *run_quality.recipe_flags(data, probe, method, final + 2),
         "--load-dir", str(run_dir / "ckpts"), "--steps-per-save", "0",
         "--steps-per-eval-image", "0", "--steps-per-eval-all-images", "0",
         *stretches[-1]["flags"]], 2)

    # the ceiling analysis on the eval views, against the final gs-eval
    gts = args.work_dir / "gtS_eval.npz"
    from gstk_torch.tools import analyze_gt_aliasing, eval_vs_supersampled

    t0 = time.perf_counter()
    ceil_rows = analyze_gt_aliasing.main([
        str(CEILING_SS), "--save", "--eval-json", str(result_json),
        "--save-path", str(gts), "--n-views", str(args.n_views), "--width",
        str(args.width), "--height", str(args.height),
        "--eval-views", str(len(evals[final]["per_image"]["psnr"])),
        *dev])
    report["ceiling"] = {
        "s": time.perf_counter() - t0,
        "gt": ("this capture's own GT" if args.capture == "1spp" else
               "a 1-spp capture of these views; this run trained on ss 3"),
        **rings([r[3] for r in ceil_rows])}
    vs = eval_vs_supersampled.main([
        str(cfg), "--gts", str(gts), "--out", str(out / "eval_vs_ss.json"),
        *dev])
    report["vs_supersampled"] = {k: v for k, v in vs.items()
                                 if k != "per_image"}

    from gstk_torch.tools.summarize_run import report as summary

    (out / "report.md").write_text(summary(run_dir))
    report["wall_s"] = time.perf_counter() - t_start
    (out / "quality.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
