"""The reference's surface-gs refinement (``docs/RESULTS_240.md``: the
vanilla 15k checkpoint resumed as surface-gs to 17000) on the CPU: the
method-switching resume against gstk_tpu, two stretches against one run,
and ``quality_workflow`` / ``tpu_precision_probe``'s command for it.

The method-switching resume: a gstk_tpu vanilla checkpoint resumed as
surface-gs in gstk_tpu's trainer and in the port's, on the fixture dataset
of ``tests/test_data.py``.

gstk_tpu trains vanilla 30 steps with ``stop_split_at`` lowered to 20
(densify and an opacity reset before it, cull-only refines after it) and
saves its checkpoint; both trainers then resume it as surface-gs to step 50,
through four cull-only refines, with ``cull_alpha_thresh`` raised so that
they cull. Required, with the tolerances of ``tests/test_torch_trainer.py``:
the logged losses within rtol 1e-3, the alive masks equal up to
``MAX_ALIVE_FLIPS`` lanes, the final ``eval_all`` PSNR within 0.05 dB; no
refine that splits, duplicates or resets the opacities, and in both
trainers the alive lanes a subset of the checkpoint's (no split, no
duplicate) and the means' gradient zero.

surface-gs freezes the means as gstk_tpu does: a zero gradient that Adam
still steps on. So on this resume the means' moments only decay, a mean
whose checkpoint momentum is zero keeps its value bit for bit, and the
others move by the momentum the vanilla run left (the port's means equal
gstk_tpu's to float rounding). ``quality_workflow.frozen_check`` holds
each trainer's final checkpoint to that.
"""

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gstk_tpu.data.dataparser import DataparserConfig as JDataparserConfig
from gstk_tpu.models.surface import SurfaceConfig as JSurfaceConfig
from gstk_tpu.models.vanilla import VanillaConfig as JVanillaConfig
from gstk_tpu.train.trainer import Trainer as JTrainer
from gstk_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gstk_torch.data.dataparser import DataparserConfig
from gstk_torch.models.surface import SurfaceConfig
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.tools import quality_workflow, run_quality
from gstk_torch.train import trainer as trainer_mod
from gstk_torch.train.checkpoint import (latest_checkpoint, peek_group,
                                         train_state_to_numpy)
from gstk_torch.train.trainer import Trainer, TrainerConfig

from tests.test_data import _make_dataset
from tests.test_torch_trainer import (
    LOSS_RTOL,
    MAX_ALIVE_FLIPS,
    PSNR_ATOL,
    _MODEL,
    _PARSER,
    _kwargs,
    _losses,
)
from tests.test_torch_quality_tools import _doc, _reference_command, _shell_recipe

torch.set_num_threads(2)

VANILLA_STEPS, REFINE_STEPS, STOP_SPLIT_AT = 30, 50, 20
# the refinement's alpha cull: the checkpoint's survivors are all above the
# vanilla 0.1; about a third of them fall under this one
CULL_ALPHA = 0.25
REPO = Path(__file__).resolve().parents[1]
PUBLISHED = REPO / "gstk_torch" / "tools" / "published" / "results_240_surfacegs.json"


def test_vanilla_checkpoint_resumed_as_surface_gs_matches_jax(
        tmp_path, monkeypatch):
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    model = dict(_MODEL, stop_split_at=STOP_SPLIT_AT)
    kw = dict(_kwargs(data, tmp_path / "j", VANILLA_STEPS),
              steps_per_save=VANILLA_STEPS, data_parallel="off")
    jcfg = JTrainerConfig(**kw, model=JVanillaConfig(**model),
                          dataparser=JDataparserConfig(data=data, **_PARSER))
    vanilla = JTrainer(jcfg)
    vanilla.setup()
    vanilla.train()
    ckpts = jcfg.run_dir / "ckpts"
    alive0 = peek_group(latest_checkpoint(ckpts))["alive"]
    assert int(alive0.sum()) != 50  # vanilla densified

    refine = dict(model, cull_alpha_thresh=CULL_ALPHA)
    jt = JTrainer(dataclasses.replace(
        jcfg, method_name="surface-gs", max_num_iterations=REFINE_STEPS,
        steps_per_save=0, load_dir=ckpts, model=JSurfaceConfig(**refine)))
    jt.setup()
    jt.train()
    j_eval = jt.eval_all(REFINE_STEPS)

    infos = []
    real_refine = trainer_mod.refine

    def counted_refine(*args, **kwargs):
        out = real_refine(*args, **kwargs)
        infos.append({k: int(v) for k, v in out[3].items()})
        return out

    monkeypatch.setattr(trainer_mod, "refine", counted_refine)
    tcfg = TrainerConfig(
        **dict(_kwargs(data, tmp_path / "t", REFINE_STEPS), steps_per_save=0,
               data_parallel="off", load_dir=ckpts),
        method_name="surface-gs", model=SurfaceConfig(**refine),
        dataparser=DataparserConfig(data=data, **_PARSER))
    tt = Trainer(tcfg, device="cpu")
    tt.setup()
    tt.train()
    t_eval = tt.eval_all(REFINE_STEPS)

    j_loss, t_loss = _losses(jt.config.run_dir), _losses(tcfg.run_dir)
    assert sorted(t_loss) == sorted(j_loss) == [30, 35, 40, 45, 49]
    for s in j_loss:
        np.testing.assert_allclose(t_loss[s], j_loss[s], rtol=LOSS_RTOL,
                                   err_msg=f"loss at step {s}")
    j_alive = np.asarray(jt.state.scene.alive)
    t_alive = tt.state.scene.alive.numpy()
    flips = int((j_alive != t_alive).sum())
    # the four cull-only refines (state steps 35-50): no split, duplicate
    # or reset, and lanes culled
    assert [i["num_split"] + i["num_dup"] + i["did_reset"]
            for i in infos] == [0, 0, 0, 0]
    culled = sum(i["num_cull"] for i in infos)
    start = latest_checkpoint(ckpts)
    checks = {name: quality_workflow.frozen_check(start, latest_checkpoint(
        cfg.run_dir / "ckpts")) for name, cfg in (("gstk_tpu", jt.config),
                                                  ("port", tcfg))}
    print(f"surface-gs resume: alive {int(alive0.sum())} -> "
          f"{int(t_alive.sum())} (gstk_tpu {int(j_alive.sum())}), "
          f"{culled} culled, {flips} flips; eval PSNR "
          f"{t_eval['eval_psnr']:.4f} (gstk_tpu {j_eval['eval_psnr']:.4f}); "
          f"{checks}")
    assert culled > 0 and flips <= MAX_ALIVE_FLIPS
    assert abs(t_eval["eval_psnr"] - j_eval["eval_psnr"]) <= PSNR_ATOL
    for name, check in checks.items():
        assert check["frozen"], (name, check)
        assert check["adam_steps"] == REFINE_STEPS - VANILLA_STEPS
        assert check["alive"][1] < check["alive"][0]
        # the vanilla run's momentum moves the means it had not zeroed
        assert check["means_moved"] > 0 and check["max_mean_shift"] > 0
    both = t_alive & j_alive
    np.testing.assert_allclose(tt.state.scene.means.detach().numpy()[both],
                               np.asarray(jt.state.scene.means)[both],
                               rtol=1e-6, atol=1e-7)
    # the same resume as vanilla, whose means get their gradient: the
    # check sees it
    vcfg = dataclasses.replace(tcfg, method_name="gaussian-splatting",
                               output_dir=tmp_path / "v",
                               model=VanillaConfig(**refine))
    moving = Trainer(vcfg, device="cpu")
    moving.setup()
    moving.train()
    check = quality_workflow.frozen_check(
        start, latest_checkpoint(vcfg.run_dir / "ckpts"))
    assert not check["frozen"] and check["moments_grown"] > 0, check


def _surface(data, out, iters, load_dir, **fields):
    cfg = TrainerConfig(
        **dict(_kwargs(data, out, iters), steps_per_save=0,
               data_parallel="off", load_dir=load_dir),
        method_name="surface-gs",
        model=SurfaceConfig(**dict(_MODEL, background_color="random")),
        dataparser=DataparserConfig(data=data, **_PARSER), **fields)
    trainer = Trainer(cfg, device="cpu")
    trainer.setup()
    return trainer


def test_two_stretches_differ_from_one_run_only_by_the_restarted_order(
        tmp_path):
    """The refinement in two stretches (20 -> 30, then its own checkpoint
    -> 40) against one run (20 -> 40) from the same vanilla checkpoint: the
    frozen means are equal, other groups are not, because a new process
    starts the camera order (the datamanager's generator) and the step's
    generator (random backgrounds) from their seeds, which no checkpoint
    holds, as in gstk_tpu. One trainer that trains to 30, restarts those
    two and trains on to 40 reaches the two stretches' state bit for
    bit."""
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    vanilla = Trainer(TrainerConfig(
        **dict(_kwargs(data, tmp_path / "v", 20), data_parallel="off"),
        model=VanillaConfig(**dict(_MODEL, background_color="random")),
        dataparser=DataparserConfig(data=data, **_PARSER)), device="cpu")
    vanilla.setup()
    vanilla.train()
    start = vanilla.config.run_dir / "ckpts"

    one = _surface(data, tmp_path / "one", 40, start)
    one.train()
    first = _surface(data, tmp_path / "two", 30, start)
    first.train()
    second = _surface(data, tmp_path / "two", 40, first.config.run_dir / "ckpts")
    second.train()
    restarted = _surface(data, tmp_path / "re", 30, start)
    restarted.train()
    restarted.config.max_num_iterations = 40
    restarted.datamanager._rng = np.random.default_rng(restarted.config.seed)
    restarted.datamanager._unseen = []
    restarted.generator.manual_seed(restarted.config.seed + 1)
    restarted.train()

    whole, parts, again = (train_state_to_numpy(t.state)
                           for t in (one, second, restarted))
    assert int(whole[".step"]) == int(parts[".step"]) == 40
    differ = sorted(k for k in whole if not np.array_equal(whole[k], parts[k]))
    print(f"two stretches vs one run: {differ} differ")
    assert differ and ".scene/.means" not in differ
    assert ".scene/.features_dc" in differ
    for k in parts:
        np.testing.assert_array_equal(again[k], parts[k], err_msg=k)


def _refinement_command():
    """(data, method, iters, the vanilla step it resumes) of the
    reference's refinement, read from ``docs/RESULTS_240.md``."""
    m = re.search(r"\(`run_quality\.sh \.\.\. (\S+) (\d+)` resuming the "
                  r"vanilla (\d+)k checkpoint\)", _doc("RESULTS_240.md"))
    data, _, _, _ = _reference_command("240")
    return data, m.group(1), m.group(2), int(m.group(3)) * 1000


def _fake_checkpoint(argv):
    """A checkpoint at gs-train's ``--max-num-iterations`` in its run: four
    lanes, the means and their moments zero."""
    ckpts = (Path(argv[argv.index("--output-dir") + 1])
             / Path(argv[argv.index("--data") + 1]).name / argv[2] / "ckpts")
    ckpts.mkdir(parents=True, exist_ok=True)
    end = int(argv[argv.index("--max-num-iterations") + 1])
    zero = np.zeros((4, 3), np.float32)
    np.savez(ckpts / f"step-{end:09d}.ckpt.npz", **{
        ".scene/.alive": np.ones(4, bool), ".scene/.means": zero,
        ".adam/.mu/['means']": zero, ".adam/.nu/['means']": zero,
        ".adam/.count": np.asarray(end, np.int32)})
    return end


def test_refinement_train_arguments_are_the_reference_command(
        tmp_path, monkeypatch):
    """``quality_workflow --capture 1spp --method surface-gs --iters
    17000`` after the vanilla configuration's command (``--capture 1spp``,
    cut in its last gs-eval): the vanilla stretches are ``run_quality.sh``'s
    launch of the 15k recipe in ``runs_240``, which the refinement reuses
    (it scores the stretch the vanilla command left unscored and trains no
    vanilla step); the refinement's first stretch is ``run_quality.sh``'s
    launch of ``surface-gs`` with the vanilla ``--load-dir`` (to 16000),
    its second the same to 17000 (the reference's ``surface-gs 17000``)
    resuming the refinement's own checkpoint; a call cut in the second
    stretch is picked up by the same command, again from the refinement's
    checkpoint."""
    monkeypatch.setattr(quality_workflow, "prepare_data",
                        lambda work, capture, *a, **k: (
                            work / quality_workflow.data_name(capture, False),
                            {}))
    trains, cut = [], []
    vanilla_report = tmp_path / "report_240"

    def python_m(module, argv, log=None):
        if module == "gstk_torch.scripts.train":
            trains.append(argv)
            if argv[argv.index("--max-num-iterations") + 1] == "17000" \
                    and not cut:
                cut.append(argv)
                raise KeyboardInterrupt("the call's time ran out")
            _fake_checkpoint(argv)
            return 0
        out = Path(argv[argv.index("--output-path") + 1])
        if out.name == "eval_17000.json" or out == vanilla_report / "eval_15000.json":
            return 1
        out.write_text(json.dumps({"results": {"psnr": 1.0, "ssim": 1.0},
                                   "per_image": {"psnr": [1.0]}}))
        return 0

    monkeypatch.setattr(quality_workflow, "_python_m", python_m)
    common = ["--device", "cpu", "--capture", "1spp", "--work-dir",
              str(tmp_path)]
    with pytest.raises(SystemExit, match="gs-eval failed"):
        quality_workflow.main([*common, "--out-dir", str(vanilla_report)])
    argv = [*common, "--method", "surface-gs", "--iters", "17000",
            "--out-dir", str(tmp_path / "report")]
    with pytest.raises(KeyboardInterrupt):
        quality_workflow.main(argv)
    with pytest.raises(SystemExit, match="gs-eval failed"):
        quality_workflow.main(argv)
    data, method, iters, base = _refinement_command()
    assert (method, iters, base) == ("surface-gs", "17000", 15000)
    ours = tmp_path / Path(data).name
    vruns, runs = tmp_path / "runs_240", tmp_path / "runs_240_surfacegs"
    vanilla = run_quality.run_dir(ours, vruns, "gaussian-splatting") / "ckpts"
    own = run_quality.run_dir(ours, runs, method) / "ckpts"
    shell = lambda r, m, n: ["--device", "cpu", *_shell_recipe(
        str(ours), str(r), m, n)]
    assert trains == [
        shell(vruns, "gaussian-splatting", "7500"),
        shell(vruns, "gaussian-splatting", str(base))
        + ["--load-dir", str(vanilla)],
        shell(runs, method, "16000") + ["--load-dir", str(vanilla)],
        shell(runs, method, iters) + ["--load-dir", str(own)],
        shell(runs, method, iters) + ["--load-dir", str(own)]]
    assert trains[3] == cut[0]
    record = lambda r: [(s["iters"], s.get("method"), s.get("load_dir"),
                         s.get("scored", False))
                        for s in json.loads((r / "stretches.json").read_text())]
    assert record(vruns) == [(7500, "gaussian-splatting", None, True),
                             (15000, "gaussian-splatting", None, True)]
    assert record(runs) == [(16000, method, str(vanilla), True),
                            (17000, method, None, False)]
    assert (tmp_path / "report" / "eval_15000.json").exists()
    assert quality_workflow.config_name(
        "1spp", method, False, [], 17000) == "240_surfacegs"


def test_refinement_is_refused_without_its_steps(tmp_path):
    """A refinement whose stretches cannot end at ``--iters`` is refused
    before any work."""
    for extra in (["--iters", "16500"], ["--iters", "45", "--stretch", "10"]):
        with pytest.raises(SystemExit) as e:
            quality_workflow.main([
                "--capture", "1spp", "--method", "surface-gs", "--work-dir",
                str(tmp_path), "--out-dir", str(tmp_path / "report"),
                "--device", "cpu", *extra])
        assert e.value.code == 2, extra
    assert not any(tmp_path.iterdir())


def test_surface_gs_from_seeds_is_kept_apart_from_the_refinement(tmp_path):
    """``--method surface-gs`` at the recipe's 15000 steps trains from the
    seeds as before (one method, no vanilla checkpoint); its run shares
    the name ``240_surfacegs`` with the refinement, which refuses to take
    such a run for its own."""
    ap = argparse.ArgumentParser()
    quality_workflow.add_config_args(ap)
    ap.add_argument("--n-views", type=int, default=240)
    for iters, methods in ((None, {"surface-gs"}),
                           ("17000", {"gaussian-splatting", "surface-gs"})):
        args = ap.parse_args(["--capture", "1spp", "--method", "surface-gs"]
                             + (["--iters", iters] if iters else []))
        method, _, names, stretches = quality_workflow.resolve_config(
            ap, args, [])
        assert names[method] == "240_surfacegs"
        assert {st.method for st in stretches} == methods
        assert (stretches[-1].base is None) == (iters is None)
    assert names == {"gaussian-splatting": "240", "surface-gs": "240_surfacegs"}
    data = tmp_path / "raytraced240"
    runs_of = {m: tmp_path / f"runs_{n}" for m, n in names.items()}
    _fake_checkpoint(["", "", "surface-gs", "--output-dir",
                      str(runs_of["surface-gs"]), "--data", str(data),
                      "--max-num-iterations", "15000"])
    with pytest.raises(SystemExit, match="trained from the seeds"):
        quality_workflow.resume_flags(stretches[2], data, runs_of)


def test_refinement_rehearsal(tmp_path):
    """``python -m gstk_torch.tools.quality_workflow --method surface-gs
    --iters 40 --stretch 10`` on the CPU at 64x64 (8 views; the vanilla recipe in two stretches of
    10 steps to step 20, standing for 15k; the refinement in two of 10 to
    40, standing for 16k and 17k; one thread, so gs-eval repeats the
    trainer's eval): the name, gs-eval equal to the trainer's eval at
    every stretch, the vanilla run in the vanilla configuration's
    directory, the second refinement stretch resuming its own checkpoint,
    the means' gradient zero across the resume (``frozen_check``),
    ``--published`` against 23.01 and 22.96."""
    out = tmp_path / "report"
    proc = subprocess.run(
        [sys.executable, "-m", "gstk_torch.tools.quality_workflow", "--device",
         "cpu", "--capture", "1spp", "--method", "surface-gs", "--work-dir",
         str(tmp_path), "--out-dir", str(out), "--n-views", "8", "--width",
         "64", "--height", "64", "--seed-points", "800", "--iters", "40",
         "--stretch", "10", "--published", str(PUBLISHED), "--",
         "--isect-capacity", "16384"],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads((out / "quality.json").read_text())
    assert report["config"] == "240_surfacegs"
    assert report["method"] == "surface-gs"
    evals = report["evals"]
    assert list(evals) == ["10", "20", "30", "40"]
    assert [e["recipe_step"] for e in evals.values()] == [
        7500, 15000, 16000, 17000]
    assert all(e["bit_for_bit"] for e in evals.values())
    assert [evals[k]["published_psnr"] for k in ("30", "40")] == [23.01, 22.96]
    assert report["published"]["psnr"] == 22.96
    assert report["published"]["precision"] == {"psnr": 0.01, "ssim": 0.0001}
    assert [(s["method"], s["load_dir"]) for s in report["stretches"]] == [
        ("gaussian-splatting", None), ("gaussian-splatting", None),
        ("surface-gs", str(tmp_path / "runs_240_stretch10" / "raytraced240"
                           / "gaussian-splatting" / "ckpts")),
        ("surface-gs", None)]
    log = (out / "train.log").read_text()
    assert re.search(r"Resumed from \S+/surface-gs/ckpts/step-0+30\.ckpt", log)
    assert log.count("Resumed from") == 3
    refinement = report["refinement"]
    assert refinement["frozen"] and refinement["base_step"] == 20
    assert refinement["lanes_born"] == refinement["moments_grown"] == 0
    assert refinement["moved_without_momentum"] == 0
    assert refinement["adam_steps"] == 20
    assert list(refinement["alive_by_step"]) == ["15000", "16000", "17000"]
    assert report["counted"]["steps"] == 2
    assert report["growth_counts"]["lanes"] == 0
    result = json.loads((out / "eval_240_surfacegs_torch.json").read_text())
    assert result["results"]["psnr"] == evals["40"]["psnr"]
    assert (result["experiment_name"], result["method_name"]) == (
        "raytraced240", "surface-gs")


def test_probe_refinement_resumes_its_own_rounded_vanilla_run(
        tmp_path, monkeypatch):
    """``tpu_precision_probe --rounded fullmat --method surface-gs``: the
    vanilla recipe and the refinement's first stretch both train with
    ``fullmat`` rounded, each in the probe's own run directory of its
    configuration (``runs_240_..._fullmat``, ``runs_240_surfacegs_...
    _fullmat``), the refinement from the probe's vanilla checkpoint, never
    the workflow's."""
    from gstk_torch.models import vanilla
    from gstk_torch.scripts import eval as eval_cli
    from gstk_torch.scripts import train as train_cli
    from gstk_torch.tools import tpu_precision_probe as probe

    monkeypatch.setattr(vanilla, "camera_matrices", vanilla.camera_matrices)
    monkeypatch.setattr(vanilla, "spherical_harmonics",
                        vanilla.spherical_harmonics)
    monkeypatch.setattr(quality_workflow, "prepare_data",
                        lambda work, capture, *a, **k: (
                            work / quality_workflow.data_name(capture, False),
                            {}))
    monkeypatch.setattr(probe, "screen_shift", lambda *a: {})
    # the workflow's vanilla run in the same work directory
    exact = run_quality.run_dir(tmp_path / "raytraced240",
                                tmp_path / "runs_240_stretch10",
                                "gaussian-splatting") / "ckpts"
    exact.mkdir(parents=True)
    np.savez(exact / "step-000000020.ckpt.npz",
             **{".scene/.alive": np.ones(4, bool)})
    seen = []

    def train(argv):
        seen.append((argv, vanilla.camera_matrices is probe._exact["cameras"]))
        _fake_checkpoint(argv)
        return type("T", (), {"growth_events": [], "peak_by_lanes": {}})()

    def stop(argv):
        raise RuntimeError("gs-eval stopped on purpose")

    monkeypatch.setattr(train_cli, "main", train)
    monkeypatch.setattr(eval_cli, "main", stop)
    with pytest.raises(RuntimeError, match="on purpose"):
        probe.main(["--rounded", "fullmat", "--capture", "1spp", "--method",
                    "surface-gs", "--work-dir", str(tmp_path), "--out-dir",
                    str(tmp_path / "report"), "--iters", "40", "--stretch",
                    "10", "--device", "cpu"])
    (vanilla_argv, v_exact), (refine_argv, r_exact) = seen
    runs = tmp_path / "runs_240_stretch10_fullmat"
    assert not v_exact and not r_exact
    assert vanilla_argv[2] == "gaussian-splatting" and "--load-dir" not in vanilla_argv
    assert vanilla_argv[vanilla_argv.index("--max-num-iterations") + 1] == "20"
    assert refine_argv[2] == "surface-gs"
    assert refine_argv[refine_argv.index("--max-num-iterations") + 1] == "30"
    out_dir = lambda a: a[a.index("--output-dir") + 1]
    assert out_dir(vanilla_argv) == str(runs)
    assert out_dir(refine_argv) == str(
        tmp_path / "runs_240_surfacegs_stretch10_fullmat")
    assert refine_argv[-2:] == ["--load-dir", str(run_quality.run_dir(
        tmp_path / "raytraced240", runs, "gaussian-splatting") / "ckpts")]
    assert vanilla.camera_matrices is probe._exact["cameras"]


def test_results_240_surfacegs_json_is_the_doc():
    doc = (REPO / "docs" / "RESULTS_240.md").read_text()
    lines = doc.splitlines()
    entry = json.loads(PUBLISHED.read_text())["configs"]["240_surfacegs"]
    m = re.search(r"eval PSNR \*\*([\d.]+) / SSIM ([\d.]+)\*\* at (\d+)k\n"
                  r"\(([\d.]+)/([\d.]+) at (\d+)k\)", doc)
    assert m, "the refinement's sentence"
    first, last = int(m.group(3)) * 1000, int(m.group(6)) * 1000
    assert entry["curve"] == {
        str(first): [float(m.group(1)), float(m.group(2))],
        str(last): [float(m.group(4)), float(m.group(5))]}
    assert entry["results"] == {"psnr": float(m.group(4)),
                                "ssim": float(m.group(5))}
    assert entry["checkpoint"] == str(last) and entry["iters"] == last
    _, method, iters, base = _refinement_command()
    assert (entry["method_name"], entry["iters"]) == (method, int(iters))
    assert entry["resumes"]["checkpoint"] == str(base)
    assert entry["experiment_name"] == Path(_reference_command("240")[0]).name
    lo, hi = (int(x) for x in entry["curve_lines"].split("-"))
    assert m.group(0).splitlines()[0] in "\n".join(lines[lo - 1:hi])
    assert "surface-gs" in lines[lo - 1] and first == 16000 and last == 17000
