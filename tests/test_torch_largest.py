"""The reference's two 30k configurations on the CPU: the command lines
of ``quality_workflow`` and ``tpu_precision_probe``, a resume with a
larger ``max_capacity`` and a later ``stop_split_at`` through both
trainers, and a cut workflow call picked up by the same command.

Tolerances:
  * the 30k command lines equal as text to ``tools/run_quality.sh``'s
    launch with the documented ``EXTRA_FLAGS`` (``docs/RESULTS_240_30K.md``)
    and continuation flags (``docs/RESULTS_240_FOLLOWUPS.md`` (c));
  * the resume: the logged losses within rtol 1e-3, the alive masks equal
    up to ``MAX_ALIVE_FLIPS`` lanes and the logged alive counts within as
    many, the growth events equal as text, the eval PSNR within 0.05 dB
    (``tests/test_torch_trainer.py``'s loop tolerances), the parameters of
    the lanes alive in both within rtol 5e-3 of the largest magnitude
    (``utils/parity.py``'s gradient tolerance) or, where that is less, 2 lr
    a step (``tests/test_torch_train_step.py``: Adam moves a parameter by
    about lr sign(g) a step, and a gradient near 0 may round either way);
  * a cut and resumed workflow call: every number of the report that does
    not time or count calls equal to one uninterrupted call's.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gstk_tpu.models.vanilla import VanillaConfig as JVanillaConfig
from gstk_tpu.data.dataparser import DataparserConfig as JDataparserConfig
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train.trainer import Trainer as JTrainer
from gstk_tpu.train.trainer import TrainerConfig as JTrainerConfig
from gstk_torch.data.dataparser import DataparserConfig
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.train.optim import OptimizerConfig
from gstk_torch.tools import quality_workflow, run_quality
from gstk_torch.tools import tpu_precision_probe as probe
from gstk_torch.train.trainer import Trainer, TrainerConfig

from tests.test_data import _make_dataset

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DOCS = REPO / "docs"
MAX_ALIVE_FLIPS = 3
LOSS_RTOL = 1e-3
PSNR_ATOL = 0.05
PARAM_RTOL = 5e-3


def _doc(name: str) -> str:
    return " ".join((DOCS / name).read_text().split())


def _shell_recipe(data: str, out: str, method: str, iters: str) -> list:
    """The gs-train arguments of ``tools/run_quality.sh``'s launch, the
    shell's variables substituted (``--load-dir`` left out)."""
    import shlex

    text = (REPO / "tools" / "run_quality.sh").read_text()
    body = text[text.index('scripts.train "$METHOD"'):
                text.index("$EXTRA_FLAGS &")]
    body = body.replace("\\\n", " ").replace(
        '${extra[@]+"${extra[@]}"}', "")
    subs = {"$METHOD": method, "$DATA": data, "$OUT": out,
            "$EXP": Path(data).name, "$ITERS": iters}
    for k, v in subs.items():
        body = body.replace(f'"{k}"', v)
    return shlex.split(body)[1:]  # "scripts.train"


def _reference_30k(config: str):
    """(data, iters, [(from step, EXTRA_FLAGS)]) of the reference's 30k
    command for ``config``, read from its docs."""
    if config == "240_30k":
        m = re.search(r'EXTRA_FLAGS="([^"]+)" bash tools/run_quality\.sh '
                      r"(\S+) \S+ gaussian-splatting (\d+)`",
                      _doc("RESULTS_240_30K.md"))
        return m.group(2), int(m.group(3)), [(0, m.group(1).split())]
    text = _doc("RESULTS_240_FOLLOWUPS.md")
    flags = re.search(r"resume the 15k checkpoint with `([^`]+)`",
                      text).group(1).split()
    assert "train to 30k" in text
    return "raytraced240_ss3", 30000, [(0, []), (15000, flags)]


CONFIGS_30K = {  # quality_workflow's flags, gs-train flags after --
    "240_30k": (["--capture", "1spp"], ["--max-capacity", "2097152"]),
    "240_ss3_30k": (["--capture", "ss3"], []),
}


@pytest.mark.parametrize("config", list(CONFIGS_30K))
def test_30k_train_arguments_are_the_reference_commands(
        config, tmp_path, monkeypatch):
    """Each stretch of ``quality_workflow --iters 30000``: gs-train's
    arguments are ``run_quality.sh``'s launch of the documented command
    with the stretch's end as its step count, the stretches past the first
    resuming the run's own checkpoints, the ss 3 run's past 15k with the
    continuation's flags; the names carry ``_30k``."""
    flags, extra = CONFIGS_30K[config]
    calls = []
    monkeypatch.setattr(quality_workflow, "prepare_data",
                        lambda work, capture, *a, **k: (
                            work / quality_workflow.data_name(capture, False),
                            {}))

    def python_m(module, argv, log=None):
        calls.append((module, argv))
        if module == "gstk_torch.scripts.train":  # a checkpoint at its end
            i = argv.index("--max-num-iterations")
            ckpts = Path(argv[argv.index("--output-dir") + 1]) / Path(
                argv[argv.index("--data") + 1]).name / argv[2] / "ckpts"
            ckpts.mkdir(parents=True, exist_ok=True)
            (ckpts / f"step-{int(argv[i + 1]):09d}.ckpt.npz").touch()
            return 0
        out = Path(argv[argv.index("--output-path") + 1])
        if out.name == "eval_30000.json":
            return 1
        out.write_text(json.dumps({"results": {"psnr": 1.0, "ssim": 1.0},
                                   "per_image": {"psnr": [1.0]}}))
        return 0

    monkeypatch.setattr(quality_workflow, "_python_m", python_m)
    with pytest.raises(SystemExit, match="gs-eval failed"):
        quality_workflow.main([
            "--device", "cpu", "--iters", "30000", "--work-dir",
            str(tmp_path), "--out-dir", str(tmp_path / "report"), *flags,
            "--", *extra])
    trains = [argv for module, argv in calls
              if module == "gstk_torch.scripts.train"]
    data, iters, ref_flags = _reference_30k(config)
    assert iters == 30000
    ours = tmp_path / Path(data).name
    runs = tmp_path / f"runs_{config}"
    ckpts = runs / ours.name / "gaussian-splatting" / "ckpts"
    assert [int(a[a.index("--max-num-iterations") + 1]) for a in trains] == [
        7500, 15000, 22500, 30000]
    for k, argv in enumerate(trains):
        end = 7500 * (k + 1)
        got = list(argv)
        if k:
            i = got.index("--load-dir")
            assert Path(got[i + 1]) == ckpts
            del got[i:i + 2]
        else:
            assert "--load-dir" not in got
        want_extra = [f for start, fl in ref_flags if end > start for f in fl]
        assert got == ["--device", "cpu", *_shell_recipe(
            str(ours), str(runs), "gaussian-splatting", str(end)),
            *want_extra], (k, got)
    names = {quality_workflow.config_name(c, m, mono, f, length)
             for c in ("ss3", "1spp") for m in ("gaussian-splatting", "co-gs")
             for mono in (False, True)
             for f in ([], ["--model.rasterize-mode", "antialiased"])
             for length in (15000, 30000)}
    assert len(names) == 32 and config in names
    assert {n for n in names if n.endswith("_30k")} == {
        n + "_30k" for n in names if not n.endswith("_30k")}
    assert (DOCS.parent / f"eval_{config}.json").exists()


@pytest.mark.parametrize("config", list(CONFIGS_30K))
def test_probe_30k_runs_and_names_like_the_workflow(
        config, tmp_path, monkeypatch):
    """``tpu_precision_probe --iters 30000 --rounded fullmat``: one run to
    30k, or the ss 3 recipe to 15k and its continuation (the continuation
    skipped when a checkpoint is past its end), in ``runs_<cfg>_fullmat``;
    gs-train sees ``fullmat`` rounded."""
    from gstk_torch.models import vanilla
    from gstk_torch.scripts import train as train_cli

    monkeypatch.setattr(vanilla, "camera_matrices", vanilla.camera_matrices)
    monkeypatch.setattr(vanilla, "spherical_harmonics",
                        vanilla.spherical_harmonics)
    flags, extra = CONFIGS_30K[config]
    data = tmp_path / quality_workflow.data_name(flags[1], False)
    monkeypatch.setattr(quality_workflow, "prepare_data",
                        lambda *a, **k: (data, {}))
    monkeypatch.setattr(probe, "screen_shift", lambda *a: {})
    seen = []

    def train(argv):
        seen.append(argv)
        assert vanilla.camera_matrices is not probe._exact["cameras"]
        if len(seen) == 2 or config == "240_30k":
            raise RuntimeError("stop here")
        ckpts = Path(argv[argv.index("--output-dir") + 1]) / data.name / \
            "gaussian-splatting" / "ckpts"
        ckpts.mkdir(parents=True)
        (ckpts / "step-000015000.ckpt.npz").touch()
        return type("T", (), {"growth_events": [], "peak_by_lanes": {}})()

    monkeypatch.setattr(train_cli, "main", train)
    with pytest.raises(RuntimeError, match="stop here"):
        probe.main(["--rounded", "fullmat", "--iters", "30000",
                    "--work-dir", str(tmp_path), "--out-dir",
                    str(tmp_path / "report"), "--device", "cpu", *flags,
                    "--", *extra])
    runs = tmp_path / f"runs_{config}_fullmat"
    iters = [a[a.index("--max-num-iterations") + 1] for a in seen]
    assert all(a[a.index("--output-dir") + 1] == str(runs) for a in seen)
    if config == "240_30k":
        assert iters == ["30000"] and seen[0][-2:] == extra
    else:
        assert iters == ["15000", "30000"]
        assert seen[0][-1] != "25000" and "--load-dir" not in seen[0]
        assert seen[1][-4:] == quality_workflow.SS3_CONTINUATION
        assert "--load-dir" in seen[1]
    assert vanilla.camera_matrices is probe._exact["cameras"]


@pytest.mark.parametrize("capture,iters,stretch,start", [
    ("ss3", 30000, 7500, 15000),   # the reference's continuation
    ("ss3", 80, 20, 40),           # a rehearsal: 20 steps stand for 7500
    ("ss3", 15000, 7500, None),    # the 15k recipe
    ("ss3", 40, 20, None),         # its rehearsal
    ("ss3", 15000, 15000, None),   # the 15k recipe in one stretch
    ("1spp", 30000, 7500, None),   # the 1-spp 30k run never continues
    ("ss3", 30000, 10000, "no stretch ends at 15000"),
    ("ss3", 80, 7, "7 does not divide 7500"),
])
def test_continuation_starts_at_the_recipes_step_15000(
        capture, iters, stretch, start, tmp_path):
    """The ss 3 continuation resumes the checkpoint of the recipe's step
    15000, read through the one step scale that also names the run and
    places its published curve; a layout of stretches without that
    checkpoint is refused, by the function and by the command line."""
    if isinstance(start, str):
        with pytest.raises(ValueError):
            quality_workflow.continuation_start(capture, iters, stretch)
        with pytest.raises(SystemExit) as e:
            quality_workflow.main([
                "--capture", capture, "--iters", str(iters), "--stretch",
                str(stretch), "--work-dir", str(tmp_path), "--out-dir",
                str(tmp_path / "report"), "--device", "cpu"])
        assert e.value.code == 2  # argparse's error, before any work
        assert not any(tmp_path.iterdir())
        return
    assert quality_workflow.continuation_start(capture, iters, stretch) == start
    length = iters * quality_workflow.step_scale(stretch)
    assert length == (30000 if iters in (30000, 80) else 15000)
    name = quality_workflow.config_name(capture, "gaussian-splatting", False,
                                        [], length)
    assert name.endswith("_30k") == (length == 30000)
    rehearsal = stretch < quality_workflow.STRETCH
    assert quality_workflow.runs_name(name, stretch) == (
        f"runs_{name}" + (f"_stretch{stretch}" if rehearsal else ""))
    args = type("A", (), {"capture": capture, "iters": iters,
                          "stretch": stretch})()
    flags = quality_workflow.stretch_flags(args, ["--x"])
    ends = quality_workflow.stretch_ends(iters, stretch)
    assert flags == [["--x"] + (quality_workflow.SS3_CONTINUATION
                                if start is not None and end > start else [])
                     for end in ends]


def test_capture_reused_only_with_its_arguments(tmp_path, monkeypatch):
    """``prepare_data(reuse=True)`` keeps a capture made with the same
    arguments and refuses one made with others (a rehearsal's capture
    under the full run's ``--work-dir``) or with none recorded."""
    from gstk_torch.data import raytraced

    made = []

    def generate(data, n_views, img_wh, seed_points, **kw):
        made.append((n_views, tuple(img_wh)))
        Path(data).mkdir(parents=True)
        (Path(data) / "transforms.json").write_text("{}")

    monkeypatch.setattr(raytraced, "generate_raytraced_dataset", generate)
    small = (tmp_path, "1spp", False, 8, (64, 64), 600)
    data, done = quality_workflow.prepare_data(*small, reuse=True)
    again, kept = quality_workflow.prepare_data(*small, reuse=True)
    assert again == data and "capture_s" in done and "capture_s" not in kept
    assert made == [(8, (64, 64))]
    with pytest.raises(SystemExit, match="remove it"):
        quality_workflow.prepare_data(tmp_path, "1spp", False, 240,
                                      (800, 800), 160_000, reuse=True)
    data.with_name(data.name + ".capture.json").unlink()
    with pytest.raises(SystemExit, match="not recorded"):
        quality_workflow.prepare_data(*small, reuse=True)
    assert made == [(8, (64, 64))]


def test_published_curves_are_the_docs():
    """The reference's eval curves beside the 30k runs: its JSONs' final
    numbers, the docs' curve at 7.5k, 15k and 22.5k."""
    curves = quality_workflow.PUBLISHED_CURVES
    for name in ("eval_240_30k.json", "eval_240_ss3_30k.json"):
        res = json.loads((REPO / name).read_text())["results"]
        psnr, ssim = curves[name][30000]
        assert abs(psnr - res["psnr"]) < 5e-4 and abs(ssim - res["ssim"]) < 5e-5
    text = _doc("RESULTS_240_30K.md")
    for step, (psnr, ssim) in curves["eval_240_30k.json"].items():
        assert f"| {step / 1000:g}k | {psnr} | {ssim} |" in text
    assert "peak 26.461 @22.5k" in _doc("RESULTS_240_FOLLOWUPS.md")
    ss3 = json.loads((REPO / "eval_240_ss3.json").read_text())["results"]
    assert abs(curves["eval_240_ss3_30k.json"][15000][0] - ss3["psnr"]) < 5e-4


# -- a resume with a larger capacity and a reopened split window -----------

_MODEL = dict(sh_degree=1, num_downscales=1, resolution_schedule=4,
              warmup_length=2, refine_every=5, background_color="black",
              densify_size_thresh=1e9, split_screen_size=1e9)
_PARSER = dict(eval_mode="interval", eval_interval=3)
# the checkpoint's run: 64 lanes (56 alive, past 0.85 of them) and its
# split window closed at step 8; the resume: four times the lanes, the
# window open to 1000
CKPT_LANES, RESUMED_MAX, STOP_SPLIT = 64, 256, 1000


def _resume_kwargs(data, out, stop_split_at=STOP_SPLIT):
    return dict(
        data=data, output_dir=out, max_num_iterations=12, steps_per_save=0,
        steps_per_eval_all_images=0, log_every=5, isect_capacity=1 << 13,
        raster_chunk=16, initial_capacity_headroom=1.0,
        max_capacity=RESUMED_MAX, data_parallel="off",
    ), stop_split_at


def _saturated_checkpoint(tmp_path, data) -> Path:
    """gstk_tpu's step-0 checkpoint of 50 seeds in 64 lanes, with six more
    lanes alive (copies of the first six, moved by 0.05)."""
    kw, _ = _resume_kwargs(data, tmp_path / "j0")
    j0 = JTrainer(JTrainerConfig(
        **kw, model=JVanillaConfig(**_MODEL, stop_split_at=8),
        dataparser=JDataparserConfig(data=data, **_PARSER)))
    j0.setup()
    assert j0.state.scene.capacity == CKPT_LANES
    init = tmp_path / "init"
    path = jckpt.save_checkpoint(init, j0.state, extras=j0._ckpt_meta())
    flat = dict(np.load(path))
    alive = flat[".scene/.alive"]
    assert int(alive.sum()) == 50
    for k in [k for k in flat if k.startswith(".scene/.") and k != ".scene/.alive"]:
        flat[k][50:56] = flat[k][0:6] + (0.05 if k.endswith("means") else 0.0)
    alive[50:56] = True
    np.savez(path, **flat)
    return init


def _port_resume(tmp_path, data, init, name, stop_split_at=STOP_SPLIT):
    kw, stop = _resume_kwargs(data, tmp_path / name, stop_split_at)
    tt = Trainer(TrainerConfig(
        **kw, load_dir=init, model=VanillaConfig(**_MODEL, stop_split_at=stop),
        dataparser=DataparserConfig(data=data, **_PARSER)), device="cpu")
    tt.setup()
    assert tt.state.scene.capacity == CKPT_LANES
    tt.train()
    return tt


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").open()]


def test_resume_with_larger_capacity_matches_jax(tmp_path, capsys):
    """Both trainers resume one saturated gstk_tpu checkpoint with four
    times its ``max_capacity`` and a split window reopened past the
    checkpoint's ``stop_split_at``: the capacity grows 64 -> 128 on the
    first metrics window in both, the refines duplicate (the split window
    is open; with the old one the port duplicates nothing) and the two
    runs agree."""
    data = _make_dataset(tmp_path, np.random.default_rng(0))
    init = _saturated_checkpoint(tmp_path, data)
    capsys.readouterr()
    kw, stop = _resume_kwargs(data, tmp_path / "j")
    jt = JTrainer(JTrainerConfig(
        **kw, load_dir=init, model=JVanillaConfig(**_MODEL, stop_split_at=stop),
        dataparser=JDataparserConfig(data=data, **_PARSER)))
    jt.setup()
    jt.train()
    j_eval = jt.eval_all(12)
    j_events = [l for l in capsys.readouterr().out.splitlines()
                if l.startswith(("Growing", "Intersections"))]
    tt = _port_resume(tmp_path, data, init, "t")
    t_eval = tt.eval_all(12)
    closed = _port_resume(tmp_path, data, init, "closed", stop_split_at=8)

    assert tt.growth_events == [
        (0, f"Growing Gaussian capacity {CKPT_LANES} -> {2 * CKPT_LANES}")]
    assert [m for _, m in tt.growth_events] == j_events
    assert tt.state.scene.capacity == jt.state.scene.capacity == 2 * CKPT_LANES
    j_rows, t_rows = _rows(jt.config.run_dir), _rows(tt.config.run_dir)
    j_loss = {r["step"]: r for r in j_rows if "loss" in r}
    t_loss = {r["step"]: r for r in t_rows if "loss" in r}
    assert sorted(t_loss) == sorted(j_loss) == [0, 5, 10, 11]
    for s in j_loss:
        np.testing.assert_allclose(t_loss[s]["loss"], j_loss[s]["loss"],
                                   rtol=LOSS_RTOL, err_msg=f"loss at {s}")
        assert abs(t_loss[s]["num_alive"] - j_loss[s]["num_alive"]) <= (
            MAX_ALIVE_FLIPS), (s, t_loss[s]["num_alive"], j_loss[s]["num_alive"])
    j_alive = np.asarray(jt.state.scene.alive)
    t_alive = tt.state.scene.alive.numpy()
    flips = int((j_alive != t_alive).sum())
    c_alive = int(closed.state.scene.alive.sum())
    print(f"resume parity: alive {int(t_alive.sum())} (gstk_tpu "
          f"{int(j_alive.sum())}; the closed window {c_alive}), {flips} "
          f"flips; eval PSNR {t_eval['eval_psnr']:.4f} (gstk_tpu "
          f"{j_eval['eval_psnr']:.4f})")
    assert flips <= MAX_ALIVE_FLIPS
    # the reopened window duplicates; the checkpoint's closed one only culls
    assert int(t_alive.sum()) > c_alive
    assert abs(t_eval["eval_psnr"] - j_eval["eval_psnr"]) <= PSNR_ATOL
    both = j_alive & t_alive
    lr = OptimizerConfig().lr_for
    for name in ("means", "scales", "quats", "features_dc", "opacities"):
        want = np.asarray(getattr(jt.state.scene, name))[both]
        got = getattr(tt.state.scene, name).detach().numpy()[both]
        # Adam moves a parameter by about lr sign(g) a step, so a gradient
        # near 0 that rounds the other way costs up to 2 lr a step
        atol = max(PARAM_RTOL * np.abs(want).max(), 2 * lr(name) * 12)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def test_resumed_config_carries_the_new_flags(tmp_path):
    """``run_quality`` with the continuation's flags after the recipe's:
    gs-train takes them over the recipe's ``--max-capacity 1048576``, and
    the ``config.yml`` the resumed launch writes (which gs-eval reads)
    holds them."""
    from gstk_torch.configs.serialize import load_config
    from gstk_torch.data.synthetic import generate_synthetic_dataset
    from gstk_torch.scripts.train import main as train_main

    data = generate_synthetic_dataset(tmp_path / "raytraced240_ss3",
                                      n_points=300, n_views=6,
                                      img_wh=(48, 32), device="cpu")
    runs = tmp_path / "runs"
    small = ["--isect-capacity", "8192", "--raster-chunk", "16",
             "--model.sh-degree", "1", "--model.num-downscales", "0",
             "--steps-per-eval-image", "0",
             "--steps-per-eval-all-images", "0",
             "--dataparser.eval-interval", "3"]
    trainers = []

    def train(argv):
        trainers.append(train_main(argv))
        return 0

    for iters, extra in ((4, small), (8, small + quality_workflow.SS3_CONTINUATION)):
        assert run_quality.main([str(data), str(runs), "gaussian-splatting",
                                 str(iters), "--device", "cpu", "--", *extra],
                                train=train) == 0
    cfg = load_config(run_quality.run_dir(data, runs, "gaussian-splatting")
                      / "config.yml")
    first, second = trainers
    assert first.config.max_capacity == 1 << 20
    assert first.config.model.stop_split_at == 10000
    assert (cfg.max_capacity, cfg.model.stop_split_at) == (1 << 21, 25000)
    assert (second.config.max_capacity, second.config.model.stop_split_at) == (
        1 << 21, 25000)
    assert int(second.state.step) == 8 and run_quality.checkpoint_step(
        run_quality.run_dir(data, runs, "gaussian-splatting")) == 8


# -- a cut workflow call picked up by the same command ---------------------

def _workflow(work: Path, python_m=None, monkeypatch=None) -> dict:
    if python_m is not None:
        monkeypatch.setattr(quality_workflow, "_python_m", python_m)
    return quality_workflow.main([
        "--device", "cpu", "--capture", "1spp", "--work-dir", str(work),
        "--out-dir", str(work / "report"), "--n-views", "8", "--width", "48",
        "--height", "48", "--seed-points", "600", "--iters", "40",
        "--stretch", "10", "--published", str(REPO / "eval_240_30k.json"),
        "--", "--isect-capacity", "16384", "--max-capacity", "2097152"])


_TIMING = ("wall_s", "gs_eval_s", "calls", "call", "iter_ms_by_lanes",
           "train_done", "s", "capture_s", "stretches", "data")


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items() if k not in _TIMING}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


def test_cut_workflow_call_is_picked_up(tmp_path, monkeypatch):
    """A 30k-configuration rehearsal (four stretches of 10 steps) cut
    after its third gs-train, before that stretch's gs-eval, then run
    again by the same command: the second call keeps the first's capture
    and two gs-evals, resumes the run, appends to ``train.log``, says
    which call ran each stretch, and reports what one uninterrupted call
    reports."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    whole = _workflow(tmp_path / "whole")
    real = quality_workflow._python_m
    seen = []

    def cut(module, argv, log=None):
        seen.append(module)
        if module == "gstk_torch.scripts.eval" and seen.count(module) == 3:
            raise KeyboardInterrupt("the call's time ran out")
        return real(module, argv, log)

    work = tmp_path / "cut"
    with pytest.raises(KeyboardInterrupt):
        _workflow(work, cut, monkeypatch)
    assert run_quality.checkpoint_step(
        work / "runs_240_30k_stretch10" / "raytraced240"
        / "gaussian-splatting") == 30
    assert sorted(p.name for p in (work / "report").glob("eval_*.json")) == [
        "eval_10.json", "eval_20.json"]
    capture = (work / "raytraced240" / "transforms.json").stat().st_mtime_ns
    again = _workflow(work, real, monkeypatch)
    assert (work / "raytraced240" / "transforms.json").stat().st_mtime_ns == capture
    assert whole["config"] == again["config"] == "240_30k"
    assert [s["call"] for s in again["stretches"]] == [1, 1, 2, 2]
    assert [s["call"] for s in whole["stretches"]] == [1, 1, 1, 1]
    assert len(again["calls"]) == 2
    log = (work / "report" / "train.log").read_text()
    assert "quality_workflow call 1" in log and "quality_workflow call 2" in log
    # gs-train resumed stretches 2 and 3 in the first call, 3 and 4 in
    # the second
    assert log.count("Resumed from") == 4
    assert all(e["bit_for_bit"] for e in again["evals"].values())
    assert [e["published_psnr"] for e in again["evals"].values()] == [
        22.809, 22.785, 22.894, 22.873]
    # as JSON: a ring without eval views has a NaN mean on both sides
    assert (json.dumps(_untimed(again), sort_keys=True)
            == json.dumps(_untimed(whole), sort_keys=True))
