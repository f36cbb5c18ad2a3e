"""The port's quality workflow (``gstk_torch/tools/{gen_raytraced_sharded,
run_quality,summarize_run,analyze_gt_aliasing,eval_vs_supersampled,
convert_lpips_weights}.py``, ``gstk_torch/examples/train_synthetic.py``)
against the reference's ``tools/`` and ``examples/`` scripts on the CPU,
at a small size.

Tolerances:
  * the sharded capture (6 views at 48x48, ss 2, 3 workers, 5000 seed
    points out of a larger pool) equal to ``tools/gen_raytraced_sharded.py``
    bit for bit: decoded PNGs (the reference writes them with Pillow, the
    port with its own writer), ``transforms.json`` and ``sparse.ply`` bytes;
  * the LPIPS converter's ``.npz`` equal array for array, its self-test
    value within rtol 1e-4 of the JAX one, and the same ``SystemExit``
    message on a wrong shape;
  * ``summarize_run`` and the recipe's flags equal as text;
  * the ceiling analysis per view within rtol 1e-9 (float64 shading on
    both sides), the supersampled GTs within 1e-12; the scores against
    them as gs-eval's parity tests hold them: PSNR rtol 1e-4, SSIM atol
    1e-4;
  * the demo's printed losses and PSNRs equal (four decimals);
  * ``quality_workflow``'s configurations: the ``1spp`` capture equal to
    gstk_tpu's serial generator bit for bit (decoded PNGs,
    ``transforms.json`` and ``sparse.ply`` bytes), its ``--mono`` variant
    equal to ``tools/make_mono_depth.py``'s (depth PNGs, frames; scale and
    shift within 1e-12), each configuration's gs-train arguments equal as
    text to the reference's command in ``docs/RESULTS_240*.md`` (the data
    and run paths aside), ``--published``'s differences and rings to the
    float, the probe with ``--method co-gs --mono --rounded fullmat`` and
    a CPU rehearsal of every configuration (64x64, 40 steps, run to rc 0).
"""

import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gstk_torch.data import raytraced as trt
from gstk_torch.tools import (
    analyze_gt_aliasing,
    convert_lpips_weights,
    eval_vs_supersampled,
    gen_raytraced_sharded,
    quality_workflow,
    run_quality,
    summarize_run,
)
from gstk_torch.utils.io import read_png

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CAPTURE = dict(n_views=6, width=48, height=48, seed_points=5000,
               supersample=2, workers=3)
TRAIN_FLAGS = [  # small and fast on the CPU, after the recipe's flags
    "--isect-capacity", "8192", "--raster-chunk", "16",
    "--model.sh-degree", "1", "--model.warmup-length", "5",
    "--model.refine-every", "5", "--steps-per-eval-image", "0",
    "--steps-per-eval-all-images", "0", "--steps-per-save", "10",
    "--log-every", "5", "--dataparser.eval-interval", "3",
]


def _reference(name: str):
    """A reference script under ``tools/`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture_argv(out: Path) -> list:
    return ["--output-dir", str(out),
            *(a for k, v in CAPTURE.items()
              for a in (f"--{k.replace('_', '-')}", str(v)))]


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The reference tool's capture (a subprocess, as its users run it)
    and the port's, on the CPU."""
    root = tmp_path_factory.mktemp("capture")
    subprocess.run([sys.executable, str(REPO / "tools" /
                                        "gen_raytraced_sharded.py"),
                    *_capture_argv(root / "ref")], check=True, cwd=root,
                   capture_output=True)
    gen_raytraced_sharded.main([*_capture_argv(root / "port"),
                                "--device", "cpu"])
    return root / "ref", root / "port"


def test_sharded_capture_matches_reference(captures):
    ref, port = captures
    for sub in ("images", "depths"):
        names = sorted(p.name for p in (ref / sub).iterdir())
        assert names == sorted(p.name for p in (port / sub).iterdir())
        assert len(names) == CAPTURE["n_views"]
        for name in names:
            a, b = read_png(ref / sub / name), read_png(port / sub / name)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a, err_msg=f"{sub}/{name}")
    for name in ("transforms.json", "sparse.ply"):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    # the pool was larger than the seed count: default_rng(0) picked
    n = json.loads((port / "transforms.json").read_text())
    assert len(n["frames"]) == CAPTURE["n_views"]
    head = (port / "sparse.ply").read_bytes()[:200].decode("latin-1")
    assert f"element vertex {CAPTURE['seed_points']}" in head


def test_serial_generator_writes_another_seed_cloud(captures, tmp_path):
    """The serial generator's images are the sharded tool's, its seed cloud
    is not (one rng for every view, supersampled colours and hit mask)."""
    _, port = captures
    serial = trt.generate_raytraced_dataset(
        tmp_path / "serial", CAPTURE["n_views"],
        (CAPTURE["width"], CAPTURE["height"]), CAPTURE["seed_points"],
        supersample=CAPTURE["supersample"], device="cpu")
    for p in sorted((port / "images").iterdir()):
        np.testing.assert_array_equal(read_png(serial / "images" / p.name),
                                      read_png(p))
    assert ((serial / "sparse.ply").read_bytes()
            != (port / "sparse.ply").read_bytes())


@pytest.mark.parametrize("ss", [1, 3])
def test_render_view_default_unchanged(ss):
    """The default four outputs, bit for bit, with and without the
    centre ray's; the centre ray's own rgb and hit are the ss-1 render."""
    objs = trt.build_scene()
    c2w = trt.view_pose(4, 12)
    fx = 0.5 * 24 / np.tan(np.radians(40.0) / 2)
    dirs = trt.camera_dirs(24, 20, fx, 12.0, 10.0, ss)
    plain = trt.render_view(objs, c2w, dirs, "cpu")
    assert len(plain) == 4
    both = trt.render_view(objs, c2w, dirs, "cpu", centre=True)
    for a, b in zip(plain, both[:4]):
        assert torch.equal(a, b)
    rgb1, _, hit1, _ = trt.render_view(objs, c2w, dirs[:1], "cpu")
    assert torch.equal(both[4], rgb1) and torch.equal(both[5], hit1)
    if ss == 1:
        assert torch.equal(plain[0], rgb1)
    else:
        assert not torch.equal(plain[0], rgb1)


# -- LPIPS converter ------------------------------------------------------

VGG_LAYERS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def _vgg_state(rng, bad: int = -1) -> dict:
    state = {}
    for i, (layer, (co, ci)) in enumerate(zip(
            VGG_LAYERS, convert_lpips_weights.VGG_CONVS)):
        shape = (co, ci, 3, 3) if i != bad else (co, ci, 1, 1)
        state[f"{layer}.weight"] = torch.from_numpy(
            rng.normal(0, 0.05, shape).astype(np.float32))
        state[f"{layer}.bias"] = torch.from_numpy(
            rng.normal(0, 0.05, co).astype(np.float32))
    return state


def _lin_state(rng, layout: str) -> dict:
    key = {"lpips_repo": "lin{j}.model.1.weight",
           "lpips_package": "lins.{j}.model.1.weight"}[layout]
    state = {key.format(j=j): torch.from_numpy(
        rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32))
        for j, c in enumerate(convert_lpips_weights.HEAD_WIDTHS)}
    if layout == "lpips_package":  # the backbone rides along, unused here
        state["net.slice1.0.weight"] = torch.zeros(64, 3, 3, 3)
    return state


@pytest.mark.parametrize("layout", ["lpips_repo", "lpips_package"])
def test_lpips_converter_matches_reference(tmp_path, layout, capsys):
    rng = np.random.default_rng(11)
    torch.save(_vgg_state(rng), tmp_path / "vgg.pth")
    torch.save(_lin_state(rng, layout), tmp_path / "lin.pth")
    args = ["--vgg", str(tmp_path / "vgg.pth"), "--lpips",
            str(tmp_path / "lin.pth")]
    _reference("convert_lpips_weights").main(
        args + ["--out", str(tmp_path / "ref.npz")])
    want = float(re.search(r"lpips\(black, white\) = ([0-9.]+)",
                           capsys.readouterr().out).group(1))
    got = convert_lpips_weights.main(
        args + ["--out", str(tmp_path / "port.npz"), "--device", "cpu"])
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 31
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fault", ["conv_shape", "head_count", "head_width"])
def test_lpips_converter_refuses_like_reference(tmp_path, fault):
    rng = np.random.default_rng(12)
    lin = _lin_state(rng, "lpips_repo")
    if fault == "head_count":
        del lin["lin4.model.1.weight"]
    if fault == "head_width":
        lin["lin2.model.1.weight"] = torch.zeros(1, 128, 1, 1)
    torch.save(_vgg_state(rng, bad=3 if fault == "conv_shape" else -1),
               tmp_path / "vgg.pth")
    torch.save(lin, tmp_path / "lin.pth")
    args = ["--vgg", str(tmp_path / "vgg.pth"), "--lpips",
            str(tmp_path / "lin.pth"), "--out", str(tmp_path / "x.npz")]
    with pytest.raises(SystemExit) as want:
        _reference("convert_lpips_weights").main(args)
    with pytest.raises(SystemExit) as got:
        convert_lpips_weights.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and str(got.value)
    assert not (tmp_path / "x.npz").exists()


# -- run_quality and summarize_run ----------------------------------------

def _shell_recipe(data: str, out: str, method: str, iters: str) -> list:
    """The gs-train arguments of ``tools/run_quality.sh``'s launch, the
    shell's variables substituted."""
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


def test_run_quality_builds_the_recipe(tmp_path):
    data, out = tmp_path / "rt240", tmp_path / "runs"
    want = _shell_recipe(str(data), str(out), "gaussian-splatting", "15000")
    assert run_quality.recipe_flags(
        data, out, "gaussian-splatting", 15000) == want
    assert run_quality.start_capacity(160_000) == 1 << 18
    got = []
    run_quality.main([str(data), str(out), "--device", "cpu", "--model.x",
                      "1", "--", "--log-every", "5"],
                     train=lambda argv: got.append(argv) or 0)
    assert got == [["--device", "cpu", *run_quality.recipe_flags(
        data, out, "gaussian-splatting", 15000), "--model.x", "1",
        "--log-every", "5"]]


@pytest.fixture(scope="module")
def quality_run(tmp_path_factory):
    """The recipe on a small synthetic capture in two stretches (20 steps,
    then resumed to 30), gs-train run in this process."""
    from gstk_torch.data.synthetic import generate_synthetic_dataset
    from gstk_torch.scripts.train import main as train_main

    root = tmp_path_factory.mktemp("quality")
    data = generate_synthetic_dataset(root / "ds", n_points=300, n_views=6,
                                      img_wh=(64, 48), device="cpu")
    calls = []

    def train(argv):
        calls.append(argv)
        train_main(argv)
        return 0

    for iters in (20, 30):
        assert run_quality.main([str(data), str(root / "runs"),
                                 "gaussian-splatting", str(iters), "--device",
                                 "cpu", *TRAIN_FLAGS], train=train) == 0
    return run_quality.run_dir(data, root / "runs", "gaussian-splatting"), calls


def test_run_quality_resumes_from_newest_checkpoint(quality_run, capsys):
    run_dir, calls = quality_run
    assert "--load-dir" not in calls[0]
    i = calls[1].index("--load-dir")
    assert Path(calls[1][i + 1]) == run_dir / "ckpts"
    rows = [json.loads(l) for l in (run_dir / "metrics.jsonl").open()]
    steps = [r["step"] for r in rows if "loss" in r]
    assert steps == [0, 5, 10, 15, 19, 20, 25, 29]
    ckpts = sorted(p.name for p in (run_dir / "ckpts").iterdir())
    assert ckpts == ["step-000000030.ckpt.npz"]


def test_summarize_run_matches_reference(quality_run, tmp_path):
    run_dir, _ = quality_run
    subprocess.run([sys.executable, str(REPO / "tools" / "summarize_run.py"),
                    str(run_dir), "--out", str(tmp_path / "ref.md"),
                    "--every", "10"], check=True, capture_output=True)
    got = summarize_run.main([str(run_dir), "--out", str(tmp_path / "p.md"),
                              "--every", "10"])
    assert got == (tmp_path / "ref.md").read_text()
    assert "| 29 |" in got and "### Eval (full eval split)" in got


# -- the ceiling analysis -------------------------------------------------

EVAL_VIEWS, SIDE, VIEWS = 2, 32, 16


@pytest.fixture(scope="module")
def ceiling(tmp_path_factory):
    root = tmp_path_factory.mktemp("ceiling")
    rows = analyze_gt_aliasing.main([
        "3", "--save", "--save-path", str(root / "gts.npz"), "--eval-json",
        str(root / "none.json"), "--n-views", str(VIEWS), "--width",
        str(SIDE), "--height", str(SIDE), "--eval-views", str(EVAL_VIEWS),
        "--device", "cpu"])
    return root, rows


def test_ceiling_matches_reference(ceiling):
    from gstk_tpu.data.raytraced import _orbit_pose, build_scene

    root, rows = ceiling
    ref = _reference("analyze_gt_aliasing")
    objs = build_scene()
    fx = 0.5 * SIDE / np.tan(np.radians(40.0) / 2)
    gts = np.load(root / "gts.npz")["gts"]
    assert gts.shape == (EVAL_VIEWS, SIDE, SIDE, 3)
    for ei in range(EVAL_VIEWS):  # the reference's loop body
        i = ei * 8
        ring = i % 3
        c2w = _orbit_pose((7.2, 6.2, 5.2)[ring], (1.2, 2.8, 4.2)[ring],
                          2 * np.pi * i / VIEWS + 0.21 * ring)
        img1, a1 = ref.render(objs, c2w, SIDE, SIDE, fx, SIDE / 2.0,
                              SIDE / 2.0, ss=1)
        imgS, aS = ref.render(objs, c2w, SIDE, SIDE, fx, SIDE / 2.0,
                              SIDE / 2.0, ss=3)
        gt1 = np.rint(img1 * 255) / 255.0 * (a1 >= 0.5)[..., None]
        gtS = imgS * aS[..., None]
        ceil = -10 * np.log10(max(np.mean((gt1 - gtS) ** 2), 1e-10))
        assert rows[ei][:3] == (ei, i, ring)
        np.testing.assert_allclose(rows[ei][3], ceil, rtol=1e-9)
        np.testing.assert_allclose(gts[ei], gtS.astype(np.float32), atol=1e-12)


def test_eval_vs_supersampled_matches_reference(ceiling, tmp_path):
    """A port run on the 16-view raytraced capture (eval views 0 and 8)
    scored by the port's tool and by the reference's steps in gstk_tpu."""
    import jax.numpy as jnp

    from gstk_torch.scripts.train import main as train_main
    from gstk_tpu.configs.serialize import load_config
    from gstk_tpu.data.datamanager import FullImageDatamanager
    from gstk_tpu.render.renderer import Renderer
    from gstk_tpu.scripts.eval import batched_eval
    from gstk_tpu.utils import losses
    from gstk_tpu.utils.colors import EVAL_BACKGROUND

    root, _ = ceiling
    data = trt.generate_raytraced_dataset(
        tmp_path / "rt", VIEWS, (SIDE, SIDE), 2000, device="cpu")
    train_main(["--device", "cpu", *run_quality.recipe_flags(
        data, tmp_path / "runs", "gaussian-splatting", 10), *TRAIN_FLAGS,
        "--dataparser.eval-interval", "8", "--model.num-downscales", "0"])
    cfg = run_quality.run_dir(data, tmp_path / "runs",
                              "gaussian-splatting") / "config.yml"
    got = eval_vs_supersampled.main([
        str(cfg), "--gts", str(root / "gts.npz"), "--out",
        str(tmp_path / "vs.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "vs.json").read_text()) == got

    config = load_config(cfg)
    renderer = Renderer(cfg.parent / "ckpts", model_config=config.model,
                        background=EVAL_BACKGROUND)
    frames = FullImageDatamanager(config.dataparser, seed=config.seed).eval_frames
    assert len(frames) == EVAL_VIEWS
    psnr1, _, _, preds = batched_eval(renderer, frames, None,
                                      return_preds=True)
    gtS = np.load(root / "gts.npz")["gts"]
    per = got["per_image"]
    for i, pred in enumerate(preds):
        pS = -10 * np.log10(max(float(np.mean((pred - gtS[i]) ** 2)), 1e-10))
        sS = float(losses.ssim(jnp.asarray(gtS[i]), jnp.asarray(pred)))
        np.testing.assert_allclose(per["psnr_vs_1spp"][i], float(psnr1[i]),
                                   rtol=1e-4)
        np.testing.assert_allclose(per["psnr_vs_ss"][i], pS, rtol=1e-4)
        np.testing.assert_allclose(per["ssim_vs_ss"][i], sS, atol=1e-4)


# -- the demo and the import rule ----------------------------------------

def test_train_synthetic_matches_reference(tmp_path):
    argv = ["--steps", "3", "--res", "32", "--n-gaussians", "200"]
    lines = {}
    for name, cmd in (
            ("ref", [str(REPO / "examples" / "train_synthetic.py")]),
            ("port", ["-m", "gstk_torch.examples.train_synthetic",
                      "--device", "cpu"])):
        out = subprocess.run(
            [sys.executable, *cmd, *argv, "--out", str(tmp_path / name)],
            check=True, capture_output=True, text=True, cwd=tmp_path,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": str(REPO)}).stdout
        lines[name] = [l for l in out.splitlines() if l.startswith("step")]
        assert (tmp_path / name / "trained.ply").stat().st_size > 0
    assert len(lines["port"]) == 2 and lines["port"] == lines["ref"]


TOOLS = ["analyze_gt_aliasing", "convert_lpips_weights", "eval_vs_supersampled",
         "gen_raytraced_sharded", "quality_workflow", "run_quality",
         "summarize_run", "tpu_precision_probe"]


def test_tools_import_neither_jax_nor_the_reference(tmp_path):
    """Every new module imports in a process where jax, gstk_tpu and the
    reference's ``tools`` cannot be imported, and the capture's CLI runs
    there."""
    code = ("import sys\n"
            "for m in ('jax', 'gstk_tpu', 'tools', 'PIL', 'cv2', 'yaml'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            + "".join(f"importlib.import_module('gstk_torch.tools.{m}')\n"
                      for m in TOOLS)
            + "importlib.import_module('gstk_torch.examples.train_synthetic')\n"
            "from gstk_torch.tools.gen_raytraced_sharded import main\n"
            f"main(['--output-dir', {str(tmp_path / 'c')!r}, '--n-views', '3',"
            " '--width', '16', '--height', '16', '--seed-points', '50',"
            " '--device', 'cpu'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'gstk_tpu', 'tools') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=tmp_path,
                   env={**os.environ, "PYTHONPATH": str(REPO)})
    assert len(list((tmp_path / "c" / "images").iterdir())) == 3


def test_precision_probe_rounds_only_what_it_names(monkeypatch):
    """The probe's camera matrices are gstk_tpu's with the named products'
    operands rounded to bfloat16 (a TPU's default f32 matmul pass), and
    setting no rounding restores the exact functions. Rounding the SH
    einsum sends ``splat_inputs`` to its plain twin, which evaluates it."""
    import jax.numpy as jnp

    from gstk_torch.core.cameras import Camera
    from gstk_torch.models import vanilla
    from gstk_torch.tools import tpu_precision_probe as probe

    # pytest puts the exact functions back even if an assert below fails
    monkeypatch.setattr(vanilla, "camera_matrices", vanilla.camera_matrices)
    monkeypatch.setattr(vanilla, "spherical_harmonics",
                        vanilla.spherical_harmonics)
    monkeypatch.setattr(vanilla, "splat_inputs", vanilla.splat_inputs)
    from gstk_tpu.core.cameras import view_matrix
    from gstk_tpu.utils.math import projection_matrix

    c2w = trt.view_pose(5, 240)[:3].astype(np.float32)
    c2w[:3, 3] *= 0.14  # the dataparser's scale of the capture
    cam = Camera.create(1099.0, 1099.0, 400.0, 400.0, c2w)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    keep = lambda x: jnp.asarray(x)
    R = jnp.asarray(c2w[:3, :3]) * jnp.asarray([1.0, -1.0, -1.0])[None, :]
    fov = 2.0 * jnp.arctan(0.5 * 800 / jnp.float32(1099.0))
    pm = projection_matrix(0.001, 1000.0, fov, fov)

    def emulated(rt, rf):
        vm = view_matrix(jnp.asarray(c2w)).at[:3, 3:4].set(
            -(rt(R.T) @ rt(c2w[:3, 3:4])))
        return vm, rf(pm) @ rf(vm)

    for parts, (rt, rf) in ((["cameras", "sh"], (bf, bf)),
                            (["tinv"], (bf, keep)), (["fullmat"], (keep, bf))):
        probe.set_rounding(parts)
        vm, fm = vanilla.camera_matrices(cam, 800, 800)
        jvm, jfm = emulated(rt, rf)
        np.testing.assert_allclose(vm.numpy(), np.asarray(jvm), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(fm.numpy(), np.asarray(jfm), rtol=1e-6,
                                   atol=1e-6)
        assert not torch.equal(fm, probe._exact["cameras"](cam, 800, 800)[1])
        assert (vanilla.spherical_harmonics is probe.rounded_spherical_harmonics
                ) == ("sh" in parts)
        assert (vanilla.splat_inputs is probe.plain_splat_inputs
                ) == ("sh" in parts)
    probe.set_rounding([])
    assert vanilla.camera_matrices is probe._exact["cameras"]
    assert vanilla.spherical_harmonics is probe._exact["sh"]
    assert vanilla.splat_inputs is probe._exact["splat"]


# -- the published configurations ----------------------------------------

SERIAL = dict(n_views=6, img_wh=(64, 64), seed_points=800)
DOCS = REPO / "docs"


def _same_files(a: Path, b: Path) -> list:
    """Files of ``a`` that differ from ``b``'s: PNGs decoded (Pillow
    writes the reference's), the rest as bytes; the file lists equal."""
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    return [str(f) for f in files if (
        not np.array_equal(read_png(a / f), read_png(b / f))
        if f.suffix == ".png" else (a / f).read_bytes() != (b / f).read_bytes())]


@pytest.fixture(scope="module")
def serial_captures(tmp_path_factory):
    """gstk_tpu's serial capture with ``tools/make_mono_depth.py``'s variant
    of it, and ``quality_workflow.prepare_data``'s ``1spp --mono`` on the
    CPU."""
    from gstk_tpu.data.raytraced import generate_raytraced_dataset

    root = tmp_path_factory.mktemp("serial")
    ref = Path(generate_raytraced_dataset(root / "ref" / "raytraced240",
                                          **SERIAL))
    assert _reference("make_mono_depth").main([
        "--data", str(ref), "--out", str(root / "ref" / "raytraced240_mono")
    ]) is None
    mono, done = quality_workflow.prepare_data(
        root / "port", "1spp", True, SERIAL["n_views"], SERIAL["img_wh"],
        SERIAL["seed_points"], "cpu")
    return root / "ref", root / "port", mono, done


def test_capture_1spp_is_the_reference_serial_capture(serial_captures):
    ref, port, _, done = serial_captures
    assert done["capture"] == "1spp" and done["capture_s"] > 0
    assert not _same_files(ref / "raytraced240", port / "raytraced240")
    assert len(list((port / "raytraced240" / "images").iterdir())) == 6


def test_mono_is_the_reference_tools_variant(serial_captures):
    ref, port, mono, done = serial_captures
    assert mono == port / "raytraced240_mono"
    assert done["mono"]["frames"] == 6
    assert done["mono"]["median_rel_scale_error"] <= 0.02
    a = json.loads((ref / mono.name / "transforms.json").read_text())
    b = json.loads((mono / "transforms.json").read_text())
    fa, fb = a.pop("frames"), b.pop("frames")
    assert a == b and len(fa) == len(fb) == 6
    for x, y in zip(fa, fb):
        for key in ("scale", "shift"):
            np.testing.assert_allclose(y[key], x[key], rtol=0, atol=1e-12)
        assert ({k: v for k, v in x.items() if k not in ("scale", "shift")}
                == {k: v for k, v in y.items() if k not in ("scale", "shift")})
    assert not _same_files(ref / mono.name / "depths_mono", mono / "depths_mono")
    for link in ("images", "sparse.ply"):
        assert ((mono / link).resolve()
                == (port / "raytraced240" / link).resolve())


def _doc(name: str) -> str:
    return " ".join((DOCS / name).read_text().split())


def _reference_command(config: str):
    """(data, method, iters, extra flags) of the reference's command for
    ``config``, read from ``docs/RESULTS_240*.md``."""
    if config == "240_mono_cogs":
        m = re.search(r'EXTRA_FLAGS="([^"]+)" STALL_S=\d+ bash '
                      r"tools/run_quality\.sh (\S+) \S+ (\S+) (\d+)`",
                      _doc("RESULTS_240_MONO.md"))
        return m.group(2), m.group(3), m.group(4), m.group(1).split()
    if config == "240_cogs":
        m = re.search(r"`tools/run_quality\.sh (\S+) \S+ (co-gs) (\d+)`",
                      _doc("RESULTS_240.md"))
        return m.group(1), m.group(2), m.group(3), []
    m = re.search(r"`bash tools/run_quality\.sh (\S+)`", _doc("RESULTS_240.md"))
    extra = []
    if config == "240_aa":  # "otherwise the exact r3 recipe"
        extra = re.search(r"\(a\) Antialiased.*?`(--model\.rasterize-mode "
                          r"\w+)`", _doc("RESULTS_240_FOLLOWUPS.md")).group(1)
        extra = extra.split()
    return m.group(1), "gaussian-splatting", "15000", extra


CONFIG_FLAGS = {  # quality_workflow's flags, gs-train flags after --
    "240": ([], []),
    "240_cogs": (["--method", "co-gs"], []),
    "240_aa": ([], ["--model.rasterize-mode", "antialiased"]),
    "240_mono_cogs": (["--mono"], []),
}


@pytest.mark.parametrize("config", list(CONFIG_FLAGS))
def test_config_train_arguments_are_the_reference_commands(
        config, tmp_path, monkeypatch):
    """The gs-train arguments ``quality_workflow`` passes for each
    configuration (``--first-stretch 15000``: the reference's one run)
    against ``tools/run_quality.sh``'s launch of the documented command."""
    flags, extra = CONFIG_FLAGS[config]
    calls = []

    def python_m(module, argv, log=None):
        calls.append((module, argv))
        return 0 if module == "gstk_torch.scripts.train" else 1

    monkeypatch.setattr(quality_workflow, "_python_m", python_m)
    with pytest.raises(SystemExit, match="gs-eval failed"):
        quality_workflow.main([
            "--device", "cpu", "--capture", "1spp", "--work-dir",
            str(tmp_path), "--out-dir", str(tmp_path / "report"),
            "--first-stretch", "15000", "--n-views", "6", "--width", "64",
            "--height", "64", "--seed-points", "800", *flags, "--", *extra])
    (module, argv), _ = calls
    data, method, iters, ref_extra = _reference_command(config)
    ours = tmp_path / Path(data).name
    assert (ours / "transforms.json").exists()  # the capture's own name
    runs = tmp_path / f"runs_{config}"
    assert argv == ["--device", "cpu", *_shell_recipe(
        str(ours), str(runs), method, iters), *ref_extra]
    name = quality_workflow.config_name(
        "1spp", method, "--mono" in flags, argv)
    assert name == config
    assert (DOCS.parent / f"eval_{name}.json").exists()


def test_published_reports_differences_and_rings():
    per = np.random.default_rng(3).uniform(15, 30, 30).tolist()
    ours = {"psnr": float(np.mean(per)), "ssim": 0.95,
            **quality_workflow.rings(per)}
    ref = json.loads((REPO / "eval_240_aa.json").read_text())
    got = quality_workflow.published_diff(ours, REPO / "eval_240_aa.json")
    ref_per = np.asarray(ref["per_image"]["psnr"], np.float64)
    ring = (np.arange(30) * 8) % 3
    assert got["psnr"] == ref["results"]["psnr"]
    assert got["d_psnr"] == ours["psnr"] - ref["results"]["psnr"]
    assert got["d_ssim"] == 0.95 - ref["results"]["ssim"]
    for r in range(3):
        want = float(ref_per[ring == r].mean())
        assert got["ring_means"][r] == want
        mine = float(np.asarray(per)[ring == r].mean())
        assert got["d_ring_means"][r] == mine - want
    assert got["min_view"] == float(ref_per.min())
    assert got["d_min_view"] == min(per) - float(ref_per.min())
    np.testing.assert_allclose(got["ring_means"], [18.92, 24.29, 26.06],
                               atol=0.005)  # docs/RESULTS_240_FOLLOWUPS.md
    line = quality_workflow.published_line(got)
    assert line.startswith("vs eval_240_aa.json: PSNR 23.091") and "rings" in line
    bare = quality_workflow.published_diff(ours, REPO / "eval_240.json")
    assert bare["psnr"] == 22.930316925048828 and "ring_means" not in bare
    assert "not published" in bare["rings"]
    assert "rings" not in quality_workflow.published_line(bare)


def test_precision_probe_mono_cogs_rounds_only_fullmat(
        serial_captures, tmp_path, monkeypatch):
    """``--method co-gs --mono --rounded fullmat``: gs-train runs with
    ``fullmat`` alone rounded and the mono flags, on the mono dataset;
    when it fails the exact functions are back."""
    from gstk_torch.core.cameras import Camera
    from gstk_torch.models import vanilla
    from gstk_torch.scripts import train as train_cli
    from gstk_torch.tools import tpu_precision_probe as probe

    monkeypatch.setattr(vanilla, "camera_matrices", vanilla.camera_matrices)
    monkeypatch.setattr(vanilla, "spherical_harmonics",
                        vanilla.spherical_harmonics)
    _, port, mono, _ = serial_captures
    seen = []

    def failing_train(argv):
        cam = Camera.create(77.0, 77.0, 32.0, 32.0, trt.view_pose(5, 6)[:3])
        vm, fm = vanilla.camera_matrices(cam, 64, 64)
        want = probe.rounded_camera_matrices(cam, 64, 64, ("fullmat",))
        exact = probe._exact["cameras"](cam, 64, 64)
        seen.append(argv)
        assert torch.equal(vm, want[0]) and torch.equal(fm, want[1])
        assert torch.equal(vm, exact[0]) and not torch.equal(fm, exact[1])
        assert vanilla.spherical_harmonics is probe._exact["sh"]
        raise RuntimeError("gs-train failed on purpose")

    monkeypatch.setattr(train_cli, "main", failing_train)
    with pytest.raises(RuntimeError, match="on purpose"):
        probe.main(["--rounded", "fullmat", "--capture", "1spp", "--method",
                    "co-gs", "--mono", "--work-dir", str(port), "--out-dir",
                    str(tmp_path / "report"), "--n-views", "6", "--size",
                    "64", "--seed-points", "800", "--iters", "40",
                    "--device", "cpu"])
    (argv,) = seen
    assert argv[argv.index("--data") + 1] == str(mono)
    assert argv[2] == "co-gs"
    flags = " ".join(argv)
    assert " ".join(quality_workflow.MONO_FLAGS) in flags
    assert vanilla.camera_matrices is probe._exact["cameras"]
    assert vanilla.spherical_harmonics is probe._exact["sh"]


@pytest.mark.parametrize("config", list(CONFIG_FLAGS))
def test_workflow_rehearsal(config, tmp_path):
    """``python -m gstk_torch.tools.quality_workflow`` for each
    configuration on the CPU at 64x64 (8 views, 40 steps in two
    stretches; one thread, so gs-eval repeats the trainer's eval)."""
    flags, extra = CONFIG_FLAGS[config]
    out = tmp_path / "report"
    proc = subprocess.run(
        [sys.executable, "-m", "gstk_torch.tools.quality_workflow", "--device",
         "cpu", "--capture", "1spp", "--work-dir", str(tmp_path), "--out-dir",
         str(out), "--n-views", "8", "--width", "64", "--height", "64",
         "--seed-points", "800", "--iters", "40", "--first-stretch", "20",
         "--published", str(REPO / f"eval_{config}.json"), *flags, "--",
         "--isect-capacity", "16384", *extra],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads((out / "quality.json").read_text())
    assert report["config"] == config
    final = report["evals"]["40"]
    assert final["bit_for_bit"] and np.isfinite(final["psnr"])
    result = json.loads((out / f"eval_{config}_torch.json").read_text())
    assert result["results"]["psnr"] == final["psnr"]
    assert result["experiment_name"] == report["published"]["experiment_name"]
    assert result["method_name"] == report["published"]["method_name"]
    assert report["counted"]["steps"] == 2
    assert report["ceiling"]["gt"] == "this capture's own GT"
