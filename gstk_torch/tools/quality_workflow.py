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
give it, its eval curve beside each stretch's gs-eval; a JSON that holds
several configurations (``published/results_15k.json``, transcribed from
``docs/RESULTS_15K.md`` and ``docs/metrics_15k.jsonl.gz``) gives the
entry of this run's name, and for the 64-view run its training curve
(alive count, intersections and train PSNR every 1000 steps; the
reference's ``Train Iter (time)`` is a TPU's and is left out). With
``--downstream`` the reference's toolchain then runs on the final
checkpoint, each tool a fresh process, timed: gs-export gaussian-splat,
gs-render pose of the training views and gs-export offline-tsdf
--meshing tetra, with their counts (the final gs-eval, a fresh process
too, is held equal to the trainer's eval as every stretch's is).

On CUDA it refuses to start on kernels without a card parity pass
(:func:`gstk_torch.tools.preflight.require_fresh`).

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
  ``docs/RESULTS_15K.md``        ``--capture 1spp --n-views 64
                                 --downstream``: the round-2 run of
                                 ``tools/run_15k.sh`` (``raytraced64``, 56
                                 train / 8 eval), with
                                 ``--published published/results_15k.json``
  its co-gs smoke                ``--capture 1spp --n-views 64 --method
                                 co-gs --iters 1500 --
                                 --model.use-depth-loss True``
  ``docs/RESULTS_240.md``,       ``--capture 1spp --method surface-gs
  its surface-gs refinement      --iters 17000``: the vanilla 15k
                                 checkpoint resumed as surface-gs, two
                                 stretches to 16000 and 17000, with
                                 ``--published
                                 published/results_240_surfacegs.json``
  =============================  ==========================================

The ss 3 30k run is the reference's continuation: its stretches past 15k
add :data:`SS3_CONTINUATION` after the recipe's flags (the later flag
wins), as the reference resumed its 15k checkpoint.

The surface-gs refinement is the reference's ``run_quality.sh ...
surface-gs 17000`` resuming its vanilla 15k checkpoint: ``--method
surface-gs`` with ``--iters`` past the recipe's 15k steps resumes the
step-15000 checkpoint of the vanilla configuration's own run (``240`` in
``runs_240``, trained first unless it is there) and trains surface-gs in
``runs_240_surfacegs`` in stretches of 1000 steps to ``--iters``; the
vanilla checkpoint's ``--load-dir`` is passed only while the refinement
has no checkpoint of its own, so a resumed stretch never goes back to it.
The report holds each run's statistics apart (``vanilla`` and the
refinement's own) and checks the refinement's final checkpoint against
the vanilla one (:func:`frozen_check`). With ``--iters`` at or below 15k,
surface-gs trains from the seeds like the other methods.

The capture's directory is named as the reference named it
(``raytraced240``, ``raytraced240_ss3``, ``raytraced240_mono``, and with
``--n-views 64`` ``raytraced64``; a rehearsal with another view count
keeps the 240-view names), so the run's ``experiment_name`` is the
reference's; the final gs-eval is copied to ``eval_<cfg>_torch.json``,
``<cfg>`` the reference's name for the run (``64`` for the 64-view run,
``_30k`` for a run past 15k steps). Each configuration trains in its own
``runs_<cfg>``, so a 30k run never resumes a 15k run's checkpoint, and a
rehearsal in ``runs_<cfg>_stretch<n>``; each run keeps there the record
of its stretches (``stretches.json``, :func:`run_plan`); a capture is
reused only if it was made with the same arguments.

Everything goes under ``--work-dir``; what a report needs (the gs-eval
JSONs, ``metrics.jsonl``, the trainer's log, ``report.md`` and
``quality.json``, whose last copy is also printed) under ``--out-dir``.
A call cut short is picked up by the same command: it keeps the capture,
resumes the run from its newest checkpoint, keeps the gs-eval of every
stretch an earlier call finished, appends to ``train.log``, and the
report says which call finished each stretch.

The ceiling analysis compares the views' 1-spp GT with a 3x3 supersampled
render, so it is the ceiling of the ``1spp`` capture's own GT; on the
``ss3`` capture it bounds a 1-spp capture of the same views, not the GT
this run trained on, and the report says which.

Usage (on the card):
  python -m gstk_torch.tools.quality_workflow --capture 1spp \\
      --published eval_240.json --out-dir runs/quality/report
CPU rehearsal at a small size (a ``--stretch`` that divides 7500 stands
for the recipe's 7500 steps, so ``--iters 80 --stretch 20`` rehearses a
30k configuration and its continuation starts at step 40; a refinement's
stretch in a rehearsal is as long and stands for its 1000 steps, so
``--method surface-gs --iters 40 --stretch 10`` rehearses the 17k
refinement of the vanilla run's step 20):
  python -m gstk_torch.tools.quality_workflow --device cpu --n-views 24 \\
      --width 64 --height 64 --seed-points 2000 --iters 40 \\
      --stretch 20 -- --isect-capacity 16384
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from gstk_torch.tools import card, launches_during, preflight, run_quality
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
# docs/RESULTS_240.md, "surface-gs (frozen-means refinement)": the vanilla
# 15k checkpoint resumed as surface-gs to 17000, its gs-eval at 16k and 17k
REFINE_METHOD, REFINE_FROM = "surface-gs", "gaussian-splatting"
REFINE_ITERS, REFINE_STRETCH = 17000, 1000
GROWTH = re.compile(r"^step (\d+): (.*)$")
CAPTURES = {"ss3": 3, "1spp": 1}  # rays per pixel axis
REFERENCE_VIEWS = (240, 64)  # the views of the reference's published captures
CEILING_SS = 3  # analyze_gt_aliasing's supersampling
# docs/RESULTS_240_MONO.md: co-gs on the mono dataset
MONO_FLAGS = ["--model.use-est-depth", "True",
              "--model.use-pearson-depth", "True",
              "--model.use-scaled-est-depth", "True",
              "--model.use-depth-regularization", "True"]


def reference_views(n_views: int) -> int:
    """The views of the reference's published capture a run of
    ``n_views`` views stands for: 64 (the round-2 run of
    ``tools/run_15k.sh``) or 240 (the others; a rehearsal with fewer views
    keeps that name)."""
    return n_views if n_views in REFERENCE_VIEWS else 240


def data_name(capture: str, mono: bool, n_views: int = 240) -> str:
    """The capture's directory, as the reference named it
    (``raytraced240``, ``raytraced64``...)."""
    return (f"raytraced{reference_views(n_views)}"
            + ("_ss3" if capture == "ss3" else "") + ("_mono" if mono else ""))


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


@dataclasses.dataclass(frozen=True)
class Stretch:
    """One gs-train call of a run: the step it trains to, the recipe's step
    that stands for, the method it trains, gs-train's flags after the
    recipe's, and for a refinement's stretch the step of the vanilla
    checkpoint the refinement starts from."""

    end: int
    recipe_step: int
    method: str
    flags: List[str]
    base: Optional[int] = None


def plan(capture: str, method: str, iters: int, stretch: int = STRETCH,
         extra: List[str] = ()) -> List[Stretch]:
    """The run's stretches: every ``stretch`` steps to ``iters``, with
    ``extra`` and past the ss 3 15k checkpoint :data:`SS3_CONTINUATION`
    after it; for the surface-gs refinement (surface-gs past the recipe's
    15k steps) the vanilla recipe's stretches to 15k, then surface-gs's
    stretches of 1000 steps (in a rehearsal of ``stretch`` steps, each
    standing for 1000). Raises unless the stretches end at the steps their
    layout needs."""
    scale = step_scale(stretch)
    if method != REFINE_METHOD or iters * scale <= RECIPE_ITERS:
        start = continuation_start(capture, iters, stretch)
        return [Stretch(end, end * scale, method, list(extra) + (
            SS3_CONTINUATION if start is not None and end > start else []))
                for end in stretch_ends(iters, stretch)]
    base = RECIPE_ITERS // scale
    length = REFINE_STRETCH if scale == 1 else stretch
    if (iters - base) % length:
        raise ValueError(f"the refinement resumes step {base} in stretches of "
                         f"{length} steps, which do not end at {iters}")
    return ([Stretch(end, end * scale, REFINE_FROM, list(extra))
             for end in stretch_ends(base, stretch)]
            + [Stretch(end, RECIPE_ITERS + (end - base) // length
                       * REFINE_STRETCH, method, list(extra), base)
               for end in range(base + length, iters + 1, length)])


def config_name(capture: str, method: str, mono: bool,
                flags: List[str], length: int = RECIPE_ITERS,
                n_views: int = 240) -> str:
    """The reference's name of the run, ``eval_<name>.json``:
    ``<views>[_ss3][_aa][_mono][_cogs|_surfacegs][_30k]``, the last for a
    run longer than the 15k recipe, or than the 17k refinement for
    surface-gs (``length`` at the recipe's scale)."""
    longest = REFINE_ITERS if method == REFINE_METHOD else RECIPE_ITERS
    return (f"{reference_views(n_views)}" + ("_ss3" if capture == "ss3" else "")
            + ("_aa" if rasterize_mode(flags) == "antialiased" else "")
            + ("_mono" if mono else "")
            + ("" if method == "gaussian-splatting"
               else "_" + method.replace("-", ""))
            + (f"_{length / 1000:g}k" if length > longest else ""))


def add_config_args(ap: argparse.ArgumentParser) -> None:
    """The options that pick one of the reference's configurations."""
    ap.add_argument("--capture", choices=sorted(CAPTURES), default="ss3")
    ap.add_argument("--mono", action="store_true",
                    help="train co-gs on the capture's mono-depth variant")
    ap.add_argument("--method", default=None,
                    help="gaussian-splatting (co-gs with --mono)")
    ap.add_argument("--published", type=Path, default=None,
                    help="the reference's gs-eval JSON of this configuration")
    ap.add_argument("--iters", type=int, default=RECIPE_ITERS,
                    help="the recipe's 15000; surface-gs past it is the "
                         "refinement of the vanilla 15k checkpoint")
    ap.add_argument("--stretch", "--first-stretch", type=int, default=STRETCH,
                    help="steps a stretch (the recipe's 7500)")


def resolve_config(ap: argparse.ArgumentParser, args,
                   extra: List[str]) -> tuple:
    """(method, gs-train flags after the recipe's, the reference's name of
    each method's run, its :func:`plan`) of :func:`add_config_args`'
    options: the run's, and for the refinement the vanilla one's it
    resumes (``240`` for ``240_surfacegs``); ``--mono`` puts its four
    flags before ``extra``."""
    method = args.method or ("co-gs" if args.mono else "gaussian-splatting")
    if args.mono and method != "co-gs":
        ap.error("--mono trains co-gs")
    extra = (list(MONO_FLAGS) if args.mono else []) + list(extra)
    try:
        stretches = plan(args.capture, method, args.iters, args.stretch, extra)
    except ValueError as e:
        ap.error(str(e))
    names = {st.method: config_name(
        args.capture, st.method, args.mono, extra, RECIPE_ITERS
        if st.method != method else stretches[-1].recipe_step, args.n_views)
        for st in stretches}
    return method, extra, names, stretches


def runs_name(cfg_name: str, stretch: int) -> str:
    """The directory the run trains in: ``runs_<cfg>``, and for a
    rehearsal ``runs_<cfg>_stretch<n>``, so that a full-size run never
    resumes a rehearsal's checkpoint."""
    return f"runs_{cfg_name}" + (
        "" if step_scale(stretch) == 1 else f"_stretch{stretch}")


def resume_flags(st: Stretch, data: Path, runs_of: Dict[str, Path]
                 ) -> List[str]:
    """gs-train's ``--load-dir`` of the vanilla checkpoint a refinement's
    stretch starts from while the refinement has no checkpoint of its own
    (with one, :func:`run_quality.train_argv` resumes it, and a vanilla
    ``--load-dir`` after it would win); [] otherwise. ``runs_of`` holds
    each method's directory of runs. Stops unless the vanilla run's newest
    checkpoint is the one of step ``st.base``, or where the refinement's
    run holds surface-gs trained from the seeds."""
    if st.base is None:
        return []
    own = run_quality.checkpoint_step(
        run_quality.run_dir(data, runs_of[st.method], st.method))
    if own > st.base:
        return []
    if own:
        raise SystemExit(
            f"{runs_of[st.method]} holds {st.method} trained from the seeds "
            f"to step {own}, not the refinement of step {st.base}; remove it "
            "or choose another --work-dir")
    vanilla = run_quality.run_dir(data, runs_of[REFINE_FROM], REFINE_FROM)
    step = run_quality.checkpoint_step(vanilla)
    if step != st.base:
        raise SystemExit(f"the refinement resumes step {st.base} of {vanilla}"
                         f", whose newest checkpoint is of step {step}")
    return ["--load-dir", str(vanilla / "ckpts")]


def run_plan(stretch_plan: List[Stretch], data: Path,
             runs_of: Dict[str, Path], train: Callable, score: Callable,
             scored: Callable = lambda st: True, dev: List[str] = ()
             ) -> Dict[int, dict]:
    """Train and score the plan's stretches, picking up what earlier calls
    did; returns the record's entry of each stretch trained or scored, by
    its end.

    Each run keeps the record of its stretches beside its checkpoints
    (``stretches.json`` in its directory of runs, ``runs_of`` by method),
    one entry a stretch, so a run is trained once whichever command reaches
    it first (the refinement and the vanilla configuration share the
    vanilla run). A stretch is trained unless its run's newest checkpoint
    has reached its end, by one :func:`run_quality.main` call through
    ``train(st, argv)``, whose dict is recorded with the call's method,
    flags, vanilla ``--load-dir`` (:func:`resume_flags`) and wall time; a
    stretch that is not ``scored`` leaves that to the next one where it
    has the same method and flags (one gs-train call to the later end).
    A ``scored`` stretch is then scored unless its entry says it was:
    ``score(st, run_dir)``, recorded with ``scored``, which stops if the
    run is already past the stretch's end."""
    entries = {}
    for i, st in enumerate(stretch_plan):
        later = stretch_plan[i + 1:i + 2]
        if (not scored(st) and later
                and (later[0].method, later[0].flags) == (st.method, st.flags)):
            continue
        runs = runs_of[st.method]
        rd = run_quality.run_dir(data, runs, st.method)
        record = runs / "stretches.json"
        done = {s["iters"]: s for s in (json.loads(record.read_text())
                                        if record.exists() else [])}
        entry = done.get(st.end, {"iters": st.end})
        save = lambda: record.write_text(json.dumps(
            list({**done, st.end: entry}.values()), indent=1))
        if run_quality.checkpoint_step(rd) < st.end:
            resume = resume_flags(st, data, runs_of)
            t0 = time.perf_counter()
            got = train(st, [str(data), str(runs), st.method, str(st.end),
                             *dev, "--", *st.flags, *resume])
            entry = {"iters": st.end, "method": st.method, "flags": st.flags,
                     "load_dir": resume[1] if resume else None,
                     "wall_s": time.perf_counter() - t0, **got}
            save()
            print(f"stretch to step {st.end} ({st.method}"
                  + (f", from {resume[1]}" if resume else "")
                  + f"): {entry['wall_s']:.1f} s", flush=True)
        else:
            print(f"stretch to step {st.end} ({st.method}): trained by an "
                  "earlier call", flush=True)
        if scored(st) and not entry.get("scored"):
            if run_quality.checkpoint_step(rd) > st.end:
                raise SystemExit(f"{rd} is past step {st.end}, which no call "
                                 "scored; remove it to train again")
            entry.update(score(st, rd), scored=True)
            save()
        entries[st.end] = entry
    return entries


def checkpoint_facts(run: Path) -> dict:
    """The alive count and the raster bands of the run's newest
    checkpoint."""
    from gstk_torch.train.checkpoint import (latest_checkpoint, peek_group,
                                             peek_meta)

    path = latest_checkpoint(Path(run) / "ckpts")
    return {"alive": int(peek_group(path)["alive"].sum()),
            "bands": int(peek_meta(path).get("bands", 1))}


def frozen_check(start: Path, end: Path) -> dict:
    """The refinement's checkpoint ``end`` against the vanilla checkpoint
    ``start`` it resumed. surface-gs's means are gstk_tpu's frozen group:
    a zero gradient that Adam still steps on, so each step in between only
    decays their moments (by ``b1`` and ``b2``) and moves a mean by the
    momentum its checkpoint carried. Reports the capacities and alive
    counts, the lanes alive at the end that were not at the start (a split
    or a duplicate), the alive means that moved and by how much at most,
    those of them whose checkpoint momentum was zero, and the moment
    entries above the start's decayed by the Adam steps in between (a
    gradient got in); ``frozen`` when the capacity is the same and the last
    three counts are 0."""
    from gstk_torch.train.checkpoint import peek_group
    from gstk_torch.train.optim import OptimizerConfig

    a, b = peek_group(start), peek_group(end)
    out = {"checkpoints": [Path(start).name, Path(end).name],
           "capacity": [len(a["alive"]), len(b["alive"])],
           "alive": [int(a["alive"].sum()), int(b["alive"].sum())],
           "adam_steps": b["count"] - a["count"]}
    if len(a["alive"]) != len(b["alive"]):
        return {**out, "frozen": False}
    adam = OptimizerConfig()
    moved = (a["value"] != b["value"]).any(-1) & b["alive"]
    # float32 decay against float64 powers: 1e-3 of slack over 2k steps
    grew = sum(int((np.abs(b[m]) > np.abs(a[m]).astype(np.float64) * beta
                    ** out["adam_steps"] * (1 + 1e-3) + 1e-37).sum())
               for m, beta in (("mu", adam.b1), ("nu", adam.b2)))
    out.update(lanes_born=int((b["alive"] & ~a["alive"]).sum()),
               means_moved=int(moved.sum()),
               max_mean_shift=float(np.abs(b["value"] - a["value"])[
                   b["alive"]].max(initial=0.0)),
               moved_without_momentum=int(
                   (moved & (a["mu"] == 0).all(-1)).sum()),
               moments_grown=grew)
    out["frozen"] = (out["lanes_born"] == out["moved_without_momentum"]
                     == out["moments_grown"] == 0)
    return out


def published_entry(path: Path, cfg_name: Optional[str] = None) -> dict:
    """The reference's published result of the run: its gs-eval JSON
    ``path``, or the entry ``cfg_name`` of a JSON that holds several
    (``"configs"``, as ``published/results_15k.json``, transcribed from its
    docs, does)."""
    ref = json.loads(Path(path).read_text())
    if "configs" not in ref:
        return ref
    if cfg_name not in ref["configs"]:
        raise SystemExit(f"{path} publishes {sorted(ref['configs'])}, not "
                         f"{cfg_name}")
    return ref["configs"][cfg_name]


def published_curve(path: Path, step: int,
                    cfg_name: Optional[str] = None) -> Optional[tuple]:
    """The reference's (PSNR, SSIM or None) at ``step`` of the run whose
    gs-eval JSON is ``path``, where its docs give it."""
    curve = published_entry(path, cfg_name).get("curve")
    if curve is not None:
        return tuple(curve[str(step)]) if str(step) in curve else None
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

    data = Path(work_dir) / data_name(capture, False, n_views)
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
    mono_dir = Path(work_dir) / data_name(capture, True, n_views)
    if not (reuse and (mono_dir / "transforms.json").exists()):
        t0 = time.perf_counter()
        done["mono"] = make_mono_depth.main(["--data", str(data), "--out",
                                             str(mono_dir)])
        done["mono_s"] = time.perf_counter() - t0
    return mono_dir, done


def published_diff(ours: dict, path: Path,
                   cfg_name: Optional[str] = None,
                   step: Optional[int] = None) -> dict:
    """The reference's gs-eval JSON ``path`` (:func:`published_entry`)
    beside ``ours`` (``psnr``, ``ssim`` and :func:`rings` of the per-view
    PSNR): its numbers and ours minus its; with ``step`` (the recipe's)
    before the JSON's checkpoint, its eval curve's PSNR and SSIM there,
    where the curve has both. A JSON without per-view numbers (or a step
    of the curve) has no rings."""
    ref = published_entry(path, cfg_name)
    res = ref["results"]
    at = (published_curve(path, step, cfg_name)
          if step is not None and str(step) != ref.get("checkpoint") else None)
    if at is not None and at[1] is not None:
        ref = {**ref, "results": {"psnr": at[0], "ssim": at[1]},
               "checkpoint": str(step), "per_image": {}}
        res = ref["results"]
    out = {"file": Path(path).name, "experiment_name": ref.get("experiment_name"),
           "method_name": ref.get("method_name"),
           "checkpoint": ref.get("checkpoint"),
           "precision": ref.get("precision", "as the JSON holds them"),
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
    if isinstance(diff.get("precision"), dict):
        line += (f" (published to {diff['precision']['psnr']:g} dB and "
                 f"{diff['precision']['ssim']:g})")
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


def lane_spans(events: List, start: int, first: int = 0) -> List:
    """(first step, lanes) spans from the capacity growths, the run's first
    step ``first`` at ``start`` lanes."""
    spans = [(first, start)]
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
                           for k in range(-(-alive[0][0] // 1000) * 1000,
                                          alive[-1][0] + 1, 1000)}}


def run_stats(rows: List[Dict], events: List, lanes: int) -> dict:
    """One run's statistics: its growth counts, its ``ITER_TRAIN_TIME`` at
    each capacity (the first logged step at ``lanes`` lanes), its alive
    counts and its most intersections, from its metrics ``rows`` and
    growth ``events``."""
    alive = [r for r in rows if "num_alive" in r]
    return {"growth_counts": growth_counts(events),
            "iter_ms_by_lanes": iter_ms_by_lanes(
                rows, lane_spans(events, lanes, rows[0]["step"])),
            "alive_end": alive[-1]["num_alive"], "alive": alive_summary(rows),
            "num_intersects_max": max(r.get("num_intersects", 0)
                                      for r in rows)}


def plan_stats(stretch_plan: List[Stretch], entries: Dict[int, dict],
               data: Path, runs_of: Dict[str, Path]) -> dict:
    """The report's statistics of the plan's runs, from the metrics of
    each run and its record's ``entries`` (:func:`run_plan`): the growth
    events and the device peak at each capacity of every gs-train call,
    and :func:`run_stats` (the first logged step at the seeds' start
    capacity); for the refinement those of its own steps (at the vanilla
    checkpoint's capacity), the vanilla run's under ``vanilla``, and under
    ``refinement`` the alive count and bands of the vanilla checkpoint and
    of the refinement's at each stretch end it scored, and
    :func:`frozen_check` of its final checkpoint against the vanilla
    one."""
    from gstk_torch.train.checkpoint import latest_checkpoint, peek_capacity

    run_dirs = {m: run_quality.run_dir(data, r, m) for m, r in runs_of.items()}
    events = {m: [] for m in run_dirs}
    peaks: Dict[int, float] = {}
    for st in stretch_plan:
        e = entries.get(st.end, {})
        events[st.method] += [tuple(x) for x in e.get("growth_events", [])]
        for lanes, mib in e.get("device_peak_by_lanes", {}).items():
            peaks[int(lanes)] = max(mib, peaks.get(int(lanes), 0.0))
    out = {"growth_events": sum(events.values(), []),
           "device_peak_by_lanes": peaks}

    def stats(method: str, lanes: Optional[int] = None) -> dict:
        rows = metrics_rows(run_dirs[method])
        return run_stats(rows, events[method], lanes or (
            run_quality.start_capacity(int(rows[0]["num_alive"]))))

    last = stretch_plan[-1]
    if last.base is None:
        return {**out, **stats(last.method)}
    start = latest_checkpoint(run_dirs[REFINE_FROM] / "ckpts")
    out.update(stats(last.method, peek_capacity(start)))
    out["vanilla"] = stats(REFINE_FROM)
    facts = {last.base: checkpoint_facts(run_dirs[REFINE_FROM]),
             **{st.end: entries[st.end] for st in stretch_plan
                if st.base is not None and "alive" in entries.get(st.end, {})}}
    recipe = {st.end: st.recipe_step for st in stretch_plan}
    out["refinement"] = {
        "base_step": last.base,
        **{f"{k}_by_step": {recipe[end]: f[k] for end, f in facts.items()}
           for k in ("alive", "bands")},
        **frozen_check(start, latest_checkpoint(
            run_dirs[last.method] / "ckpts"))}
    print(f"refinement: {out['refinement']}", flush=True)
    return out


def metrics_rows(run: Path) -> List[Dict]:
    """The rows of the run's ``metrics.jsonl``."""
    return [json.loads(l) for l in (Path(run) / "metrics.jsonl").open()
            if l.strip()]


def rings(per_view: List[float]) -> dict:
    """Mean PSNR of each ring (frame index mod 3) and the lowest view."""
    arr = np.asarray(per_view, np.float64)
    ring = (np.arange(len(arr)) * EVAL_INTERVAL) % 3
    return {"ring_means": [float(arr[ring == r].mean()) for r in range(3)],
            "min_view": float(arr.min()), "min_view_index": int(arr.argmin()),
            "mean": float(arr.mean())}


def ply_counts(path: Path) -> Dict[str, int]:
    """The element counts of a PLY file's header (``vertex``, ``face``)."""
    counts = {}
    with open(path, "rb") as f:
        for line in f:
            words = line.decode("ascii", "replace").split()
            if words[:1] == ["element"]:
                counts[words[1]] = int(words[2])
            elif words[:1] == ["end_header"]:
                return counts
    raise ValueError(f"{path}: no PLY header end")


def downstream(cfg: Path, out: Path, dev: List[str], log: Path) -> dict:
    """The reference's toolchain on the run's final checkpoint
    (``docs/RESULTS_15K.md``), each a fresh ``python -m`` process, timed:
    ``gs-export gaussian-splat`` (its Gaussian count, beside the
    checkpoint's alive count: the last refine culls after the last logged
    step), ``gs-render pose`` of the training views (their count) and
    ``gs-export offline-tsdf --meshing tetra`` (the mesh's vertices and
    faces), written under ``out``."""
    from gstk_torch.train.checkpoint import latest_checkpoint, peek_group

    stage = {"checkpoint_alive": int(peek_group(latest_checkpoint(
        cfg.parent / "ckpts"))["alive"].sum())}
    for name, module, argv in (
        ("gaussian_splat", "gstk_torch.scripts.export",
         ["gaussian-splat", "--output-dir", str(out / "export")]),
        ("render_pose", "gstk_torch.scripts.render",
         ["pose", "--output-dir", str(out / "renders")]),
        ("tsdf_tetra", "gstk_torch.scripts.export",
         ["offline-tsdf", "--meshing", "tetra", "--output-dir",
          str(out / "export")]),
    ):
        t0 = time.perf_counter()
        if _python_m(module, [*argv, "--load-config", str(cfg), *dev], log):
            raise SystemExit(f"{module} {argv[0]} failed; see {log}")
        stage[name] = {"s": time.perf_counter() - t0}
        print(f"downstream {name}: {stage[name]['s']:.1f} s", flush=True)
    stage["gaussian_splat"]["gaussians"] = ply_counts(
        out / "export" / "gaussians.ply")["vertex"]
    stage["render_pose"]["views"] = len(json.loads(
        (out / "renders" / "poses.json").read_text()))
    mesh = ply_counts(out / "export" / "tsdf_mesh.ply")
    stage["tsdf_tetra"].update(vertices=mesh["vertex"], faces=mesh["face"])
    return stage


def train_curve_beside(rows: List[Dict], published: Dict,
                       scale: int = 1) -> Dict:
    """The run's training rows nearest each step of the reference's curve
    (``num_alive``, ``num_intersects`` and the train ``psnr``) beside it;
    a rehearsal's step stands for ``scale`` of the recipe's."""
    train = [r for r in rows if "num_alive" in r]
    keys = ("num_alive", "num_intersects", "psnr")
    out = {}
    for step, ref in published.items():
        ours = min(train, key=lambda r: abs(r["step"] * scale - int(step)))
        out[step] = {"step": ours["step"],
                     **{k: ours.get(k) for k in keys},
                     "published": {k: ref[k] for k in keys}}
    return out


def counted_steps(argv: List[str], steps: int) -> dict:
    """Train ``steps`` steps in this process from the run's last
    checkpoint (``argv`` resumes it), the evals off, and count K1-K4."""
    from gstk_torch.scripts.train import main as train_main
    from gstk_torch.train.trainer import Trainer

    eval_all = Trainer.eval_all
    Trainer.eval_all = lambda self, step: {}
    run = {}
    try:
        launches = launches_during(lambda: run.update(trainer=train_main(argv)))
    finally:
        Trainer.eval_all = eval_all
    trainer = run["trainer"]
    return {"steps": steps, "bands": trainer.raster_cfg.bands,
            "isect_capacity": trainer.raster_cfg.isect_capacity,
            "capacity": trainer.state.scene.capacity, "launches": launches}


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
    ap.add_argument("--downstream", action="store_true",
                    help="then gs-export, gs-render pose and the TSDF mesh "
                         "on the final checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    method, extra, names, stretch_plan = resolve_config(ap, args, extra)
    cfg_name = names[method]
    preflight.require_fresh(args.device, "quality_workflow")
    t_start = time.perf_counter()
    dev = [] if args.device is None else ["--device", args.device]
    out = args.out_dir
    out.mkdir(parents=True, exist_ok=True)
    # each run trains in its configuration's directory, where it keeps the
    # record of its stretches; this call's number is kept beside the
    # checkpoints of the configuration asked for: a call cut short is
    # picked up by the next one
    runs_of = {m: args.work_dir / runs_name(n, args.stretch)
               for m, n in names.items()}
    runs = runs_of[method]
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
        report["card"] = card()
        print(report["card"], flush=True)

    data, report["data"] = prepare_data(
        args.work_dir, args.capture, args.mono, args.n_views,
        (args.width, args.height), args.seed_points, args.device, reuse=True)

    run_dir = run_quality.run_dir(data, runs, method)
    cfg = run_dir / "config.yml"

    def train(st: Stretch, argv: List[str]) -> dict:
        """One gs-train call, its output appended to the log; what the log
        says of it."""
        size = log.stat().st_size
        rc = run_quality.main(argv, train=lambda a: _python_m(
            "gstk_torch.scripts.train", a, log))
        if rc:
            raise SystemExit(f"gs-train failed (rc {rc}); see {log}")
        with open(log, "rb") as f:
            f.seek(size)
            text = f.read().decode("utf-8", "replace")
        return {"trained_in": call, "config": names[st.method],
                "growth_events": [(int(m.group(1)), m.group(2)) for m in (
                    GROWTH.match(l) for l in text.splitlines()) if m],
                "device_peak_mib": [float(x) for x in re.findall(
                    r"Device peak ([0-9.]+) MiB", text)],
                "device_peak_by_lanes": peak_by_lanes(text),
                "train_done": re.findall(r"Training done in ([0-9.]+) min",
                                         text)}

    def score(st: Stretch, rd: Path) -> dict:
        """gs-eval of the stretch's checkpoint (a fresh process), and for
        the refinement the checkpoint's alive count and bands."""
        eval_json = out / f"eval_{st.end}.json"
        t0 = time.perf_counter()
        if _python_m("gstk_torch.scripts.eval", [
                "--load-config", str(rd / "config.yml"), "--output-path",
                str(eval_json), "--skip-lpips", *dev]):
            raise SystemExit("gs-eval failed")
        return {"eval_json": str(eval_json.resolve()), "call": call,
                "gs_eval_s": time.perf_counter() - t0,
                **(checkpoint_facts(rd) if st.base is not None else {})}

    entries = run_plan(stretch_plan, data, runs_of, train, score, dev=dev)
    report["stretches"] = stretches = [entries[st.end] for st in stretch_plan]
    evals = {st.end: json.loads(Path(e["eval_json"]).read_text())
             for st, e in zip(stretch_plan, stretches)}
    final = stretch_plan[-1].end
    shutil.copy(run_dir / "metrics.jsonl", out / "metrics.jsonl")
    rows_of = {m: metrics_rows(run_quality.run_dir(data, r, m))
               for m, r in runs_of.items()}
    rows = rows_of[method]

    # gs-eval against the trainer's own eval at each stretch's end
    # (gs-train's eval_all after its last step), and the per-ring table
    report["evals"] = {}
    for st, rec in zip(stretch_plan, stretches):
        iters = st.end
        trained = [r for r in rows_of[st.method]
                   if "eval_psnr" in r and r["step"] == iters]
        res = evals[iters]["results"]
        entry = {"psnr": res["psnr"], "ssim": res["ssim"],
                 "gs_eval_s": rec["gs_eval_s"], "call": rec["call"],
                 "method": st.method, "recipe_step": st.recipe_step,
                 **rings(evals[iters]["per_image"]["psnr"])}
        if trained:
            entry["trainer_psnr"] = trained[-1]["eval_psnr"]
            entry["trainer_ssim"] = trained[-1]["eval_ssim"]
            entry["bit_for_bit"] = (res["psnr"] == trained[-1]["eval_psnr"]
                                    and res["ssim"] == trained[-1]["eval_ssim"])
        ref = (published_curve(args.published, st.recipe_step, cfg_name)
               if args.published is not None else None)
        if ref is not None:
            entry["published_psnr"], entry["published_ssim"] = ref
            entry["d_published_psnr"] = res["psnr"] - ref[0]
            print(f"step {iters}: PSNR {res['psnr']:.3f}, the reference "
                  f"{ref[0]:.3f} ({entry['d_published_psnr']:+.3f})",
                  flush=True)
        report["evals"][iters] = entry
    result_json = out / f"eval_{cfg_name}_torch.json"
    shutil.copy(stretches[-1]["eval_json"], result_json)
    if args.published is not None:
        report["published"] = published_diff(report["evals"][final],
                                             args.published, cfg_name)
        print(published_line(report["published"]), flush=True)
        pub = published_entry(args.published, cfg_name)
        if "train_curve" in pub:
            report["train_curve"] = train_curve_beside(
                rows, pub["train_curve"]["rows"], step_scale(args.stretch))
    if args.downstream:
        report["downstream"] = {
            "gs_eval": {k: report["evals"][final].get(k) for k in
                        ("psnr", "ssim", "gs_eval_s", "bit_for_bit")},
            **downstream(cfg, args.work_dir / f"downstream_{cfg_name}", dev,
                         log)}
        if args.published is not None:
            report["downstream"]["published"] = published_entry(
                args.published, cfg_name).get("downstream")
        print(f"downstream: {report['downstream']}", flush=True)

    report["device_peak_mib"] = [x for e in stretches
                                 for x in e.get("device_peak_mib", [])]
    report["train_done"] = [x for e in stretches
                            for x in e.get("train_done", [])]
    report.update(plan_stats(stretch_plan, entries, data, runs_of))

    # one counted stretch of 2 steps from the final checkpoint
    probe = args.work_dir / "probe"
    shutil.rmtree(probe, ignore_errors=True)
    report["counted"] = counted_steps(
        [*dev, *run_quality.recipe_flags(data, probe, method, final + 2),
         "--load-dir", str(run_dir / "ckpts"), "--steps-per-save", "0",
         "--steps-per-eval-image", "0", "--steps-per-eval-all-images", "0",
         *stretch_plan[-1].flags], 2)

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
