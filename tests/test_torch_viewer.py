"""gstk_torch's live viewer on the CPU: the HTTP server, the training
viewer's frames against gstk_tpu's, its snapshot, the trainer with
``vis="viewer"``, the export commands and gs-viewer.

  * gstk_tpu's four viewer tests (``tests/test_viewer_and_camera_opt.py``),
    with the PNG signature where they check JPEG's: ``orbit_pose`` (equal
    to gstk_tpu's), ``/render``, the keyframe editor, the control panel and
    the export tab;
  * ``TrainingViewer.render`` against gstk_tpu's ``TrainingViewer`` render
    function (bound to port 0, never served) on one gstk_tpu checkpoint:
    rgb, depth, the crop box and an SH override; uint8 within 1 level, 0.1%
    of pixels allowed outside (the 1/255 cutoff, ROADMAP Queue 3 item 1);
  * the snapshot: after ``update_scene``, changing the scene in place does
    not change the next frame;
  * the launch counter under eight threads (``_build.count_launch``);
  * ``gstk_torch.scripts.train --vis viewer`` trains on the CPU while a
    thread polls ``/render``;
  * every ``export_command`` parses with the port's gs-export / gs-render
    argument parsers;
  * ``python -m gstk_torch.scripts.viewer --device cpu`` serves a run in a
    process where importing jax, gstk_tpu and Pillow fails.
"""

import json
import re
import shlex
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstk_tpu.models import vanilla as jvan
from gstk_tpu.ops.rasterize import RasterizeConfig as JRasterizeConfig
from gstk_tpu.render.renderer import Renderer as JRenderer
from gstk_tpu.train import checkpoint as jckpt
from gstk_tpu.train.step import init_train_state
from gstk_tpu.viewer import http_viewer as jviewer
from gstk_torch import _build
from gstk_torch.configs.methods import method_configs
from gstk_torch.configs.serialize import save_config
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.render.renderer import Renderer
from gstk_torch.scripts import export as export_cli
from gstk_torch.scripts import render as render_cli
from gstk_torch.viewer.http_viewer import (
    DEFAULT_SETTINGS,
    TrainingViewer,
    ViewerServer,
    orbit_pose,
)
from tests._torch_run import TRAIN_ARGS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PNG = b"\x89PNG\r\n\x1a\n"
BLOCK = ('import sys; sys.modules["jax"] = sys.modules["gstk_tpu"] = '
         'sys.modules["PIL"] = None\n'
         'import torch; torch.set_num_threads(2)\n')
H, W = 48, 64
N, CAPACITY, SH = 400, 512, 3


def _get(base, path, timeout=30):
    return urllib.request.urlopen(base + path, timeout=timeout).read()


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode())
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


# -- gstk_tpu's viewer tests -----------------------------------------------------

def test_orbit_pose_looks_at_center():
    c2w = orbit_pose(0.7, 0.3, 2.0, (1.0, 0.5, -0.5))
    np.testing.assert_array_equal(c2w, jviewer.orbit_pose(0.7, 0.3, 2.0,
                                                          (1.0, 0.5, -0.5)))
    to_center = np.array([1.0, 0.5, -0.5]) - c2w[:3, 3]
    to_center /= np.linalg.norm(to_center)
    np.testing.assert_allclose(-c2w[:3, 2], to_center, atol=1e-6)
    np.testing.assert_allclose(c2w[:3, :3].T @ c2w[:3, :3], np.eye(3), atol=1e-6)
    # straight down: the degenerate 'right' falls back to +x
    top = orbit_pose(0.0, np.pi / 2, 2.0, (0, 0, 0))
    np.testing.assert_array_equal(top, jviewer.orbit_pose(0.0, np.pi / 2, 2.0,
                                                          (0, 0, 0)))


def test_http_viewer_serves(rng):
    frames = []

    def render(c2w, h, w, settings):
        frames.append((c2w, settings))
        return (rng.uniform(0, 255, (h, w, 3))).astype(np.uint8)

    server = ViewerServer(render, host="127.0.0.1", port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert b"gstk_torch viewer" in _get(base, "/")
        server.update_stats({"loss": 0.5})
        assert json.loads(_get(base, "/stats")) == {"loss": 0.5}
        resp = urllib.request.urlopen(base + "/render?az=0.3&el=0.1&r=2.5",
                                      timeout=10)
        assert resp.headers["Content-Type"] == "image/png"
        body = resp.read()
        assert body[:8] == PNG
        assert len(frames) == 1
        np.testing.assert_array_equal(frames[0][0], orbit_pose(0.3, 0.1, 2.5,
                                                               (0, 0, 0)))
        with pytest.raises(urllib.error.HTTPError):
            _get(base, "/nothing")
    finally:
        server.stop()


def test_viewer_trajectory_editor():
    server = ViewerServer(
        lambda c2w, h, w, settings: np.zeros((h, w, 3), np.uint8),
        host="127.0.0.1", port=0,
    ).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        r = json.loads(_get(base, "/keyframe/add?az=0.0&el=0.2&r=3"))
        assert r["num_keyframes"] == 1
        with pytest.raises(urllib.error.HTTPError):  # one keyframe: no path
            _get(base, "/trajectory?steps=10")
        r = _post(base, "/keyframe/add", {"c2w": np.eye(4)[:3].tolist()})
        assert r["num_keyframes"] == 2
        path = json.loads(_get(base, "/trajectory?steps=10&fov=60&w=640&h=480"))
        assert len(path["camera_path"]) == 11  # 10 interpolated + final
        assert path["render_width"] == 640
        assert len(path["camera_path"][0]["camera_to_world"]) == 16
        assert json.loads(_get(base, "/keyframe/clear"))["num_keyframes"] == 0
    finally:
        server.stop()


def test_viewer_control_panel_and_export():
    seen = []

    def render(c2w, h, w, settings):
        seen.append((h, w, dict(settings)))
        return np.zeros((h, w, 3), np.uint8)

    server = ViewerServer(
        render, host="127.0.0.1", port=0,
        run_info={"config_path": "/runs/x/config.yml", "export_dir": "/exp"},
    ).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        new = {"bg": [1.0, 0.0, 0.0], "output": "depth", "sh_degree": 1,
               "max_res": 64, "crop_enabled": True, "crop_min": [-1, -1, -1],
               "crop_max": [1, 1, 1]}
        got = _post(base, "/settings", new)
        assert got["sh_degree"] == 1 and got["crop_enabled"] is True
        assert json.loads(_get(base, "/settings")) == got
        _get(base, "/render?az=0")
        h, w, s = seen[-1]
        assert max(h, w) <= 64
        assert s["output"] == "depth" and s["bg"] == [1.0, 0.0, 0.0]
        for az in (0.0, 1.0, 2.0):
            _get(base, f"/keyframe/add?az={az}&el=0.2&r=3")
        kfs = json.loads(_get(base, "/keyframes"))["keyframes"]
        assert len(kfs) == 3
        _get(base, "/keyframe/move?i=2&dir=-1")
        kfs2 = json.loads(_get(base, "/keyframes"))["keyframes"]
        assert kfs2[1] == kfs[2] and kfs2[2] == kfs[1]
        assert json.loads(_get(base, "/keyframe/delete?i=0"))["num_keyframes"] == 2
        assert _get(base, "/render_pose?i=0")[:8] == PNG
        json.loads(_get(base, "/trajectory?steps=4"))
        assert _get(base, "/render_traj?i=2")[:8] == PNG
        for kind, frag in [
            ("gaussian-splat", "gaussian-splat --load-config /runs/x/config.yml"),
            ("offline-tsdf", "--meshing poisson"),
            ("render-trajectory", "scripts.render trajectory"),
        ]:
            cmd = json.loads(_get(base, f"/export_cmd?type={kind}"))["command"]
            assert frag in cmd, cmd
    finally:
        server.stop()


# -- export commands against the port's CLIs ---------------------------------------

@pytest.mark.parametrize("kind", ["gaussian-splat", "point-cloud", "offline-tsdf",
                                  "camera-poses", "render-trajectory"])
def test_export_commands_parse(monkeypatch, kind):
    """Each command names a port module and flags its parser accepts; the
    subcommand's function is replaced by a recorder, so nothing runs."""
    server = ViewerServer(lambda *a: None, host="127.0.0.1", port=0,
                          run_info={"config_path": "/runs/my run/config.yml",
                                    "export_dir": "/exp"})
    try:
        argv = shlex.split(server.export_command(kind))
    finally:
        server.stop()
    assert argv[:2] == ["python", "-m"]
    module = {"gstk_torch.scripts.export": export_cli,
              "gstk_torch.scripts.render": render_cli}[argv[2]]
    got = []
    for name in dir(module):
        if re.match(r"(export|render)_", name):
            monkeypatch.setattr(module, name, lambda args: got.append(args))
    module.main(argv[3:])
    (args,) = got
    assert args.command == kind.replace("render-", "")
    assert str(args.load_config) == "/runs/my run/config.yml"
    if kind == "render-trajectory":
        assert str(args.trajectory_path) == "camera_path.json"
    else:
        assert str(args.output_dir) == "/exp"
    assert server.export_command("nothing").startswith("unknown")


# -- the training viewer against gstk_tpu's ----------------------------------------

def _scene_arrays(rng):
    """N Gaussians around the origin, in CAPACITY lanes, SH degree 3."""
    k = (SH + 1) ** 2
    arrays = {
        "means": rng.uniform(-1, 1, (N, 3)),
        "scales": rng.uniform(-3.5, -2.0, (N, 3)),
        "quats": rng.normal(size=(N, 4)),
        "features_dc": rng.normal(size=(N, 3)),
        "features_rest": 0.3 * rng.normal(size=(N, k - 1, 3)),
        "opacities": rng.uniform(-1.0, 3.0, (N, 1)),
    }
    for key, v in arrays.items():
        pad = np.zeros((CAPACITY - N,) + v.shape[1:])
        if key == "quats":
            pad[:, 0] = 1.0
        arrays[key] = np.concatenate([v, pad]).astype(np.float32)
    arrays["alive"] = np.arange(CAPACITY) < N
    return arrays


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory: gstk_tpu's checkpoint of the scene above and the
    port's gaussian-splatting config (SH degree 3)."""
    from gstk_tpu.core.gaussians import GaussianScene as JScene

    root = tmp_path_factory.mktemp("viewer_run")
    arrays = _scene_arrays(np.random.default_rng(0))
    state = init_train_state(JScene(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    jckpt.save_checkpoint(root / "ckpts", state._replace(step=jnp.int32(77)),
                          extras={"isect_capacity": 1 << 14, "bands": 1,
                                  "sh_degree": SH})
    save_config(root / "config.yml", method_configs()["gaussian-splatting"])
    return root


def _viewers(run_dir):
    """(the port's TrainingViewer, gstk_tpu's), each given the checkpoint's
    scene; gstk_tpu's is bound to port 0 and never served."""
    raster = dict(isect_capacity=1 << 14)
    ours = TrainingViewer(VanillaConfig(sh_degree=SH),
                          RasterizeConfig(forward_only=True, **raster),
                          host="127.0.0.1", port=0, device="cpu")
    ours.update_scene(Renderer(run_dir, device="cpu").scene, {"step": 77})
    theirs = jviewer.TrainingViewer(jvan.VanillaConfig(sh_degree=SH),
                                    JRasterizeConfig(**raster), port=0)
    theirs.update_scene(JRenderer(run_dir).scene)
    return ours, theirs


SETTINGS = {
    "rgb": {},
    "depth": {"output": "depth"},
    "crop": {"crop_enabled": True, "crop_min": [-0.6, -0.5, -1.0],
             "crop_max": [0.4, 0.7, 0.5], "bg": [0.9, 0.1, 0.3]},
    "sh1": {"sh_degree": 1},
}


@pytest.mark.parametrize("case", list(SETTINGS))
def test_training_viewer_matches_gstk_tpu(run_dir, case):
    ours, theirs = _viewers(run_dir)
    try:
        settings = {**DEFAULT_SETTINGS, **SETTINGS[case]}
        for az, el, r in ((0.3, 0.2, 3.0), (2.1, -0.4, 2.6)):
            c2w = orbit_pose(az, el, r, (0.0, 0.1, 0.0))
            got = ours.render(c2w, H, W, settings)
            want = theirs.server.render_fn(c2w, H, W, settings)
            assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
            diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
            assert (diff > 1).mean() <= 1e-3, (case, int((diff > 1).sum()))
            assert len(np.unique(got)) > 8  # a scene, not a blank frame
    finally:
        ours.stop()
        theirs.server._httpd.server_close()


def test_snapshot_is_a_clone(run_dir):
    viewer = TrainingViewer(VanillaConfig(sh_degree=SH),
                            RasterizeConfig(isect_capacity=1 << 14,
                                            forward_only=True),
                            host="127.0.0.1", port=0, device="cpu")
    try:
        c2w = orbit_pose(0.3, 0.2, 3.0, (0.0, 0.0, 0.0))
        assert not viewer.render(c2w, H, W, DEFAULT_SETTINGS).any()  # no scene yet
        scene = Renderer(run_dir, device="cpu").scene
        viewer.update_scene(scene)
        before = viewer.render(c2w, H, W, DEFAULT_SETTINGS)
        with torch.no_grad():  # what adam_step, refine and growth do
            scene.means.add_(0.5)
            scene.opacities.fill_(-20.0)
            scene.alive[::2] = False
        np.testing.assert_array_equal(viewer.render(c2w, H, W, DEFAULT_SETTINGS),
                                      before)
        viewer.update_scene(scene)
        assert not np.array_equal(viewer.render(c2w, H, W, DEFAULT_SETTINGS), before)
    finally:
        viewer.stop()


def test_launch_counter_under_threads():
    """Eight threads add 20000 launches each to one counter with a short
    switch interval; none is lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper) for _ in range(20000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 8 * 20000


def test_train_with_viewer_while_polling(tmp_path, monkeypatch):
    """``--vis viewer`` on the CPU: the trainer serves its snapshots while a
    client thread polls ``/render`` every 50 ms; every frame is a PNG and
    none is blank once the first snapshot is in."""
    from gstk_torch.data.synthetic import generate_synthetic_dataset
    from gstk_torch.scripts.train import main as train_main

    generate_synthetic_dataset(tmp_path / "ds", n_points=300, n_views=6,
                               img_wh=(64, 48), device="cpu")
    servers, frames, errors = [], [], []
    start = ViewerServer.start

    def start_and_record(self):
        servers.append(self)
        return start(self)

    monkeypatch.setattr(ViewerServer, "start", start_and_record)
    done = threading.Event()

    def poll():
        while not servers and not done.is_set():
            time.sleep(0.01)
        if not servers:
            return
        base = f"http://127.0.0.1:{servers[0].port}"
        try:
            _post(base, "/settings", {"max_res": 64})
            while not done.is_set():
                body = _get(base, "/render?az=0.5&el=0.3&r=4.0")
                assert body[:8] == PNG
                frames.append(body)
                time.sleep(0.05)
        except Exception as exc:  # reported by the test thread below
            errors.append(repr(exc))

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        trainer = train_main(["--device", "cpu", "gaussian-splatting",
                              "--data", str(tmp_path / "ds"), "--output-dir",
                              str(tmp_path / "out"), "--vis", "viewer",
                              "--viewer-port", "0", *TRAIN_ARGS])
        assert trainer.viewer is not None and trainer.viewer.server is servers[0]
        base = f"http://127.0.0.1:{servers[0].port}"
        stats = json.loads(_get(base, "/stats"))
        assert np.isfinite(stats["loss"]) and stats["num_alive"] > 0
        last = _get(base, "/render?az=0.5&el=0.3&r=4.0")
    finally:
        done.set()
        poller.join(timeout=60)
        for server in servers:
            server.stop()
    assert not poller.is_alive() and not errors, errors
    from gstk_torch.utils.io import read_png

    path = tmp_path / "frame.png"
    path.write_bytes(last)
    img = read_png(path)
    assert img.shape == (48, 64, 3) and img.max() > img.min()
    assert frames  # the poller was served while the trainer stepped


def test_gs_viewer_cli_without_jax_gstk_tpu_pillow(run_dir):
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCK + f"""
import runpy
sys.argv = ["viewer", "--load-config", {str(run_dir / "config.yml")!r},
            "--port", "0", "--device", "cpu"]
runpy.run_module("gstk_torch.scripts.viewer", run_name="__main__")
"""], cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        # gs-viewer serves from "Viewer running at ..." on, and publishes
        # the scene and its stats only then: wait for the line after it
        port, loaded = None, False
        deadline = time.monotonic() + 120
        lines = []
        while not loaded and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            found = re.search(r"http://localhost:(\d+)", line)
            if found:
                port = int(found.group(1))
            loaded = port is not None and line.startswith(
                "Viewer running; Ctrl-C to exit.")
        assert port is not None and loaded, "".join(lines)
        base = f"http://127.0.0.1:{port}"
        assert b"gstk_torch viewer" in _get(base, "/")
        assert json.loads(_get(base, "/stats")) == {"step": 77}
        _post(base, "/settings", {"max_res": 64})
        frame = _get(base, "/render?az=0.3&el=0.2&r=3.0")
        assert frame[:8] == PNG
        cmd = json.loads(_get(base, "/export_cmd?type=gaussian-splat"))["command"]
        assert str(run_dir / "config.yml") in cmd
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_viewer_options_checked(tmp_path, monkeypatch):
    import dataclasses

    from gstk_torch.train.trainer import Trainer

    cfg = dataclasses.replace(method_configs()["gaussian-splatting"], vis="tensorboard")
    with pytest.raises(ValueError, match="none or viewer"):
        Trainer(cfg, device="cpu")._check_supported()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainingViewer(VanillaConfig(), RasterizeConfig(), host="127.0.0.1", port=0)
