"""The quality recipe with a TPU's default f32 matmul rounding emulated in
chosen products: does it explain gstk_tpu's published quality on the
band-limited capture?

A TPU runs an f32 ``jnp.dot`` / ``@`` / ``einsum`` at JAX's default
precision as one bfloat16 pass: each operand is rounded to bfloat16 and
the products are summed in f32. gstk_tpu forces full precision in its
rasterizer and SSIM, but not in two places of the training step:

  * ``cameras``: ``core/cameras.py::camera_matrices``, ``t_inv = -R_inv @
    t`` (``tinv`` alone) and ``fullmat = projmat @ viewmat`` (``fullmat``
    alone), which place every Gaussian's centre on the screen;
  * ``sh``: ``ops/sh.py::spherical_harmonics``, the colour's einsum of the
    SH bases and coefficients.

This script replaces those products in the port with the same rounding
(``torch.bfloat16`` round-to-nearest-even operands, f32 products and sums),
makes the capture and the configuration's dataset as
:mod:`gstk_torch.tools.quality_workflow` makes them (``--capture``,
``--mono``) unless ``--work-dir`` has them, runs
:mod:`gstk_torch.tools.run_quality` with ``--method`` in this process, and
scores the run with gs-eval twice: with the rounding (as gs-eval on a TPU
would) and without it, each beside the reference's published JSON when
``--published`` names it. It also prints, for the capture's train cameras
at full resolution, how far the rounding moves the seed points on the
screen. The exact functions are put back however the run ends.

Usage:
  python -m gstk_torch.tools.tpu_precision_probe --rounded fullmat \\
      --capture 1spp --method co-gs --published eval_240_cogs.json \\
      --out-dir runs/probe [--iters 15000] [--device cpu] [-- flags]

``--iters 30000`` names a run ``_30k`` as the workflow does; on the ss 3
capture it trains the 15k recipe to 15k and resumes it with
:data:`~gstk_torch.tools.quality_workflow.SS3_CONTINUATION`. ``--method
surface-gs --iters 17000`` is the workflow's refinement: the vanilla
recipe to 15k with the same rounding, in the probe's own run directory of
the vanilla configuration (``runs_240_fullmat``, trained first unless it
is there), then surface-gs from that checkpoint in stretches of 1000
steps, each scored rounded and exact (``scored`` in the report; the last
also as ``eval_rounded`` / ``eval_exact``). Each run keeps the record of
its stretches as the workflow's does
(:func:`~gstk_torch.tools.quality_workflow.run_plan`). A call cut short
is picked up by the same command: the run resumes from its newest
checkpoint, and a stretch scored by an earlier call is not scored again.
With ``--published`` the report also sets the trainer's evals beside the
reference's eval curve where its docs give one.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from gstk_torch.core import cameras
from gstk_torch.models import vanilla
from gstk_torch.ops import sh
from gstk_torch.tools import run_quality
from gstk_torch.tools import quality_workflow as qw
from gstk_torch.utils.math import projection_matrix

_exact = {"cameras": vanilla.camera_matrices, "sh": vanilla.spherical_harmonics}


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in f32: a default-precision MXU
    operand."""
    return x.to(torch.bfloat16).to(torch.float32)


def rounded_camera_matrices(camera, img_height: int, img_width: int,
                            products=("tinv", "fullmat")):
    """``camera_matrices`` with ``products`` at TPU default precision."""
    rt = bf16 if "tinv" in products else (lambda x: x)
    rf = bf16 if "fullmat" in products else (lambda x: x)
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=camera.c2w.dtype,
                        device=camera.c2w.device)
    R = camera.c2w[:3, :3] * flip[None, :]
    t = camera.c2w[:3, 3:4]
    R_inv = R.T
    t_inv = -(rt(R_inv) @ rt(t))
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype,
                          device=R.device)
    viewmat = torch.cat([torch.cat([R_inv, t_inv], dim=1), bottom], dim=0)
    fovx = 2.0 * torch.atan(0.5 * img_width / camera.fx)
    fovy = 2.0 * torch.atan(0.5 * img_height / camera.fy)
    projmat = projection_matrix(0.001, 1000.0, fovx, fovy)
    return viewmat, rf(projmat) @ rf(viewmat)


def rounded_spherical_harmonics(degree: int, viewdirs, coeffs):
    """``spherical_harmonics`` with its einsum at TPU default precision."""
    basis_dim = sh.num_sh_bases(degree)
    bases = sh.eval_sh_bases(basis_dim, viewdirs.detach())
    return torch.einsum("...k,...kc->...c", bf16(bases),
                        bf16(coeffs[..., :basis_dim, :]))


def set_rounding(parts: List[str]) -> None:
    products = tuple(p for p in ("tinv", "fullmat")
                     if p in parts or "cameras" in parts)
    vanilla.camera_matrices = (
        (lambda c, h, w: rounded_camera_matrices(c, h, w, products))
        if products else _exact["cameras"])
    vanilla.spherical_harmonics = (rounded_spherical_harmonics
                                   if "sh" in parts else _exact["sh"])


def screen_shift(data: Path, size: int, products) -> dict:
    """Pixels by which rounding ``products`` moves the seed points that
    the exact ``fullmat`` puts on the screen, over the train cameras at
    ``size`` x ``size``: the median and the largest per camera."""
    from gstk_torch.data.dataparser import DataparserConfig, parse_transforms

    out = parse_transforms(DataparserConfig(data=data, eval_mode="interval",
                                            eval_interval=8), "train")
    pts = torch.from_numpy(out.points3d_xyz.astype(np.float32))
    hom = torch.cat([pts, torch.ones(len(pts), 1)], dim=1).double()
    scale = size / float(out.widths[0])
    med, worst = [], []
    for i in range(len(out.poses)):
        cam = cameras.Camera.create(out.fx[i] * scale, out.fy[i] * scale,
                                    out.cx[i] * scale, out.cy[i] * scale,
                                    out.poses[i])
        pix = []
        for fn in (_exact["cameras"],
                   lambda c, h, w: rounded_camera_matrices(c, h, w, products)):
            ph = fn(cam, size, size)[1].double() @ hom.T
            pix.append(torch.stack([0.5 * size * ph[0] / (ph[3] + 1e-6),
                                    0.5 * size * ph[1] / (ph[3] + 1e-6)]))
        on = ((pix[0] > -0.5 * size) & (pix[0] < 0.5 * size)).all(0)
        d = (pix[0] - pix[1]).abs().amax(0)[on]
        med.append(float(d.median()))
        worst.append(float(d.max()))
    return {"median_px": float(np.median(med)), "max_px": max(worst),
            "cameras": len(med)}


def main(argv=None) -> dict:
    argv, extra = run_quality.split_extra(argv)
    ap = argparse.ArgumentParser("tpu_precision_probe")
    ap.add_argument("--rounded", default="cameras",
                    help="comma-separated: cameras (tinv and fullmat), "
                         "tinv, fullmat, sh")
    qw.add_config_args(ap)
    ap.add_argument("--work-dir", type=Path, default=Path("runs/probe"))
    ap.add_argument("--out-dir", type=Path, default=Path("runs/probe/report"))
    ap.add_argument("--n-views", type=int, default=240)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--seed-points", type=int, default=160_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    parts = [p for p in args.rounded.split(",") if p]
    if not set(parts) <= {"cameras", "tinv", "fullmat", "sh"}:
        ap.error(f"--rounded: unknown part in {parts}")
    method, extra, names, stretch_plan = qw.resolve_config(ap, args, extra)
    cfg_name = names[method]
    dev = [] if args.device is None else ["--device", args.device]
    from gstk_torch.scripts import eval as eval_cli
    from gstk_torch.scripts.train import main as train_main

    t0 = time.perf_counter()
    data, prepared = qw.prepare_data(
        args.work_dir, args.capture, args.mono, args.n_views,
        (args.size, args.size), args.seed_points, args.device, reuse=True)
    products = [p for p in ("tinv", "fullmat") if p in parts or "cameras" in parts]
    report = {"config": cfg_name, "method": method, "rounded": parts,
              "extra_flags": extra, "data": prepared,
              "screen_shift": screen_shift(data, args.size, products)}
    print(f"rounded {products} vs exact: {report['screen_shift']}", flush=True)

    # each run in its configuration's directory with this rounding, so the
    # refinement resumes the probe's own rounded vanilla run
    name = "_".join(parts) or "exact"
    runs_of = {m: args.work_dir / f"{qw.runs_name(n, args.stretch)}_{name}"
               for m, n in names.items()}
    last = stretch_plan[-1]

    def train(st, argv):
        got = {}

        def one(a):
            trainer = train_main(a)
            got.update(growth_events=trainer.growth_events,
                       device_peak_by_lanes=trainer.peak_by_lanes)
            return 0 if trainer else 1

        rc = run_quality.main(argv, train=one)
        if rc:
            raise SystemExit(f"gs-train failed (rc {rc})")
        return got

    def score(st, rd):
        """gs-eval of the stretch's checkpoint with the rounding and
        exact, and for the refinement its alive count and bands."""
        out = qw.checkpoint_facts(rd) if st.base is not None else {}
        for label, on in (("rounded", parts), ("exact", [])):
            set_rounding(on)
            suffix = "" if st is last else f"_{st.end}"
            res = eval_cli.main([
                "--load-config", str(rd / "config.yml"), "--output-path",
                str(args.out_dir
                    / f"eval_{cfg_name}_{name}_{label}{suffix}.json"),
                "--skip-lpips", *dev])
            ev = {**{k: res["results"][k] for k in ("psnr", "ssim")},
                  **qw.rings(res["per_image"]["psnr"])}
            if args.published is not None:
                ev["published"] = qw.published_diff(
                    ev, args.published, cfg_name, st.recipe_step)
                print(f"step {st.end} {label}: "
                      + qw.published_line(ev["published"]), flush=True)
            out[label] = ev
        set_rounding(parts)
        return out

    args.out_dir.mkdir(parents=True, exist_ok=True)
    set_rounding(parts)
    try:
        # one gs-train call to --iters; for the ss 3 30k run the 15k recipe
        # and then its continuation (quality_workflow.SS3_CONTINUATION); for
        # the refinement the vanilla recipe and then each of its stretches,
        # each scored
        entries = qw.run_plan(
            stretch_plan, data, runs_of, train, score,
            scored=lambda st: st.base is not None or st is last, dev=dev)
    finally:
        set_rounding([])
    report["scored"] = {st.end: {k: v for k, v in entries[st.end].items()
                                 if k in ("alive", "bands", "rounded", "exact")}
                        for st in stretch_plan
                        if entries.get(st.end, {}).get("scored")}
    report["eval_rounded"] = entries[last.end]["rounded"]
    report["eval_exact"] = entries[last.end]["exact"]
    rows = qw.metrics_rows(run_quality.run_dir(data, runs_of[method], method))
    report["trainer_evals"] = [(r["step"], r["eval_psnr"], r["eval_ssim"])
                               for r in rows if "eval_psnr" in r]
    if args.published is not None:
        # the in-loop evals log the step before a stretch's end
        at = {st.end: st.recipe_step for st in stretch_plan
              if st.method == method}
        report["published_curve"] = {
            end: [psnr, ref[0], psnr - ref[0]]
            for step, psnr, _ in report["trainer_evals"]
            for end in [step if step in at else step + 1] if end in at
            for ref in [qw.published_curve(args.published, at[end],
                                           cfg_name)]
            if ref is not None}
    shutil.copy(run_quality.run_dir(data, runs_of[method], method)
                / "metrics.jsonl",
                args.out_dir / f"metrics_{cfg_name}_{name}.jsonl")
    report.update(qw.plan_stats(stretch_plan, entries, data, runs_of))
    report["wall_s"] = time.perf_counter() - t0
    (args.out_dir / f"probe_{cfg_name}_{name}.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
