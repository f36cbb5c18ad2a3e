"""The trainer's loop for co-gs as traffic: :mod:`.train`'s loop, with the
method's depth terms and camera optimisation. The program's ``Trainer`` is
built with the configuration's ``DepthConfig`` (sensor depth L1 and the
planar prior) and an SO(3) x R3 ``CameraOptConfig``; its state carries the
camera group (``init_train_state(num_cameras=...)``, one adjustment a
train view), its device cache holds each train view's sensor depth beside
its RGBA target, and ``_cam_indices`` gives each step its ``camera_index``.
The iteration is :meth:`.train.TrainLoop.step_once`, unchanged: the same
``Trainer`` calls as ``Trainer.train``'s.

The inputs (:func:`train_targets`): the capture's own draw rendered by the
plain reference at the exact poses, as RGBA (as :func:`gsbench.scene.target`
makes it) and as sensor depth (accumulated depth over alpha where alpha is
not 0, plus a normal speckle of ``depth_noise``; 0 elsewhere); the train
cameras carry a pose error drawn from ``capture_seed`` (:func:`pose_error`),
which the camera group learns to undo.

Each refine is counted: the lanes alive before it
(``counts.refine_alive_before``), those it found dead and left alive
(``refine_filled``) and those it wrote children into, dead before or
freed by its own cull (``refine_written``: alive after it, and dead
before or holding a new mean). The
step count stays inside the densifying stretch of the schedule: a refine
at step :data:`WRAP_AT` takes the state's step back to :data:`WRAP_TO`
(``counts.step_wraps``), so every refine of a run both culls and
densifies and none resets the opacities.

The comparison (:meth:`TrainCogs.verify`) is :mod:`.train`'s with the
camera group as a seventh group and the plain reference of
:mod:`gsbench.reference.cogs`: the first three steps from the drawn scene
and, after the window, three steps whose third ends a densifying refine.
Their changes are taken before that refine; the refine is checked twice:
``late_alive_lanes`` counts the lanes alive on one side only after each
side's own stretch (round-off can move a lane across a threshold of the
refine, so a few may differ), and ``late_refine_gap`` compares the lanes
the refine wrote with the reference's refine of the program's own state
just before it (so that every selection is the same on both sides), by
the worst group's norm of the difference over the reference's norm.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from gsbench import scene as gscene
from gsbench.drivers.train import CHECK_STEPS, LATE, TrainLoop, Views
from gsbench.reference import cogs as rcogs
from gsbench.reference import splat as rsplat
from gsbench.reference import train as rtrain
from gsbench.reference.precision import Arith, strict_f32

GROUPS = rcogs.GROUPS + (rcogs.CAMERA,)
# the densifying stretch of the schedule that the run stays in: the
# refines from step 12,400 to 14,900 densify (step % 3000 > 310), the one
# at 15,000 does not and 15,100 resets the opacities
WRAP_AT, WRAP_TO = 14_900, 12_400
_SOURCES = ("scene.py", "reference/splat.py", "reference/precision.py",
            "drivers/train_cogs.py")


def pose_error(cap: gscene.Capture, cfg: Dict) -> torch.Tensor:
    """Every view's c2w with the configuration's pose error: a translation
    and a rotation vector in the camera's frame, each coordinate normal
    with standard deviation ``pose_error.translation`` (scene units) and
    ``pose_error.rotation`` (radians), drawn from ``capture_seed`` and
    right-multiplied as the camera group's own adjustment is (in float64,
    then rounded to float32)."""
    err = cfg["pose_error"]
    rng = np.random.default_rng([int(cfg["capture_seed"]), 7])
    n = cap.poses.shape[0]
    delta = torch.tensor(np.concatenate(
        [rng.normal(0.0, float(err["translation"]), (n, 3)),
         rng.normal(0.0, float(err["rotation"]), (n, 3))], 1))
    c2w = cap.poses.double().cpu()
    out = torch.stack([rcogs.adjusted_c2w(c2w[i], delta[i]) for i in range(n)])
    return out.to(device=cap.poses.device, dtype=torch.float32)


def target(cap: gscene.Capture, i: int, params: Dict[str, torch.Tensor],
           cfg: Dict):
    """View ``i``'s RGBA target, as :func:`gsbench.scene.target` makes it,
    and its sensor depth (H, W) float32: the same render's accumulated
    depth over its alpha plus a normal speckle of ``scene.depth_noise``
    where the alpha is not 0, else 0."""
    noise, seed = gscene.target_noise(cfg)
    view = rsplat.View(cap.poses[int(i)], cap.fx, cap.fy, cap.cx, cap.cy,
                       cap.height, cap.width)
    black = torch.zeros(3, device=cap.poses.device)
    with strict_f32():
        out = rsplat.render(params, view, 3, black, 1, Arith())
    alpha = out["alpha"][..., None]
    rgb = torch.where(alpha > 0, out["rgb"] / torch.clamp(alpha, min=1e-12), 0.0)
    gen = torch.Generator(device=rgb.device)
    gen.manual_seed(int(seed) * 1_000_003 + int(i))
    rgb = rgb + torch.where(alpha > 0, noise * torch.randn(
        rgb.shape, generator=gen, device=rgb.device), 0.0)
    rgba = torch.cat([torch.clamp(rgb, 0.0, 1.0), alpha], -1)
    gen.manual_seed((int(seed) + 1) * 1_000_003 + int(i))
    speckle = float(cfg["scene"]["depth_noise"]) * torch.randn(
        alpha.shape[:2], generator=gen, device=rgb.device)
    depth = torch.where(alpha[..., 0] > 0,
                        torch.clamp(out["depth"] + speckle, min=1e-6), 0.0)
    return torch.round(rgba * 255.0).to(torch.uint8), depth


def train_targets(cap: gscene.Capture, cfg: Dict, cache: Path):
    """The train split's RGBA targets (n, H, W, 4) uint8 and sensor depths
    (n, H, W) float32 on the poses' device, and the seconds spent making
    them (0 when loaded): :func:`target` of every train view of the
    capture's scene, made once per checkout and kept under ``cache``."""
    key = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for src in _SOURCES:
        key.update((Path(gscene.__file__).parent / src).read_bytes())
    stem = Path(cache) / f"cogs-{key.hexdigest()[:16]}"
    paths = [stem.with_name(stem.name + s) for s in ("-rgba.npy", "-depth.npy")]
    device = cap.poses.device
    if all(p.is_file() for p in paths):
        return (*(torch.from_numpy(np.load(p)).to(device) for p in paths), 0.0)
    t0 = time.perf_counter()
    params = gscene.draw_scene(cfg, cap, int(cfg["capture_seed"]), device)
    n, h, w = len(cap.train), cap.height, cap.width
    rgba = torch.empty((n, h, w, 4), dtype=torch.uint8, device=device)
    depth = torch.empty((n, h, w), dtype=torch.float32, device=device)
    for j, i in enumerate(cap.train):
        rgba[j], depth[j] = target(cap, int(i), params, cfg)
    stem.parent.mkdir(parents=True, exist_ok=True)
    for path, x in zip(paths, (rgba, depth)):
        tmp = path.with_suffix(f".tmp{os.getpid()}.npy")
        np.save(tmp, x.cpu().numpy())
        os.replace(tmp, path)
    return rgba, depth, time.perf_counter() - t0


def _masked_norm(v: torch.Tensor, alive: torch.Tensor) -> float:
    lane = alive.reshape(alive.shape + (1,) * (v.ndim - 1))
    return float(torch.linalg.norm(torch.where(lane, v, 0.0).double()))


class TrainCogs(TrainLoop):
    """One co-gs train cell: ``setup``, ``window``, ``traced``,
    ``verify``."""

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        t_in = time.perf_counter()
        from gstk_torch.core.camera_opt import CameraOptConfig
        from gstk_torch.core.cameras import Camera
        from gstk_torch.core.gaussians import GaussianScene
        from gstk_torch.models.depth import DepthConfig
        from gstk_torch.ops.rasterize import RasterizeConfig
        from gstk_torch.train.step import init_train_state
        from gstk_torch.train.trainer import Trainer, TrainerConfig

        cfg, dev = self.cfg, self.device
        t0 = time.perf_counter()
        cap = self.cap = gscene.capture(cfg, dev)
        self.poses = pose_error(cap, cfg)
        tensors = self._start_scene()
        self.run.sync()
        t1 = time.perf_counter()
        self.targets, self.depths, self.dataset_made_s = train_targets(
            cap, cfg, self.run.root / "build" / "gsbench")
        self.run.sync()
        t2 = time.perf_counter()
        self.model = DepthConfig(**cfg["depth"])
        tcfg = TrainerConfig(
            max_num_iterations=int(cfg["max_num_iterations"]),
            log_every=int(self.traffic["log_every"]),
            isect_capacity=int(cfg["isect_capacity"]),
            max_capacity=int(cfg["capacity"]), model=self.model,
            camera_opt=CameraOptConfig(**cfg["camera_opt"]),
            steps_per_save=0, steps_per_eval_image=0,
            steps_per_eval_all_images=0,
        )
        t = self.trainer = Trainer(tcfg, device=dev)
        n = len(cap.train)
        t.datamanager = Views(n, self.run.derived_seed(1), (cap.height, cap.width))
        t.state = init_train_state(GaussianScene(**tensors), num_cameras=n)
        t.state.step.fill_(int(cfg["start_step"]))
        t.raster_cfg = RasterizeConfig(chunk_size=tcfg.raster_chunk,
                                       isect_capacity=int(cfg["isect_capacity"]),
                                       bands=int(cfg["bands"]))
        t.generator = torch.Generator(device=dev)
        t.generator.manual_seed(self.run.derived_seed(2))
        t.step_generator = t.generator
        t._cam_indices = torch.arange(n, dtype=torch.int32, device=dev)
        full = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)
        cams = Camera(fx=full(cap.fx), fy=full(cap.fy), cx=full(cap.cx),
                      cy=full(cap.cy), c2w=self.poses[torch.as_tensor(cap.train)])
        t._dev_cache = {1: (cams, self.targets, None, self.depths, None, None)}
        # every refine through the counting wrapper (Trainer._refine inside)
        self._trainer_refine = t._refine
        t._refine = self._refine
        self.filled: List[torch.Tensor] = []
        self.keep_refine = False
        self.wraps = 0
        self.step = int(cfg["start_step"])
        self.refines = 0
        t3 = time.perf_counter()

        losses = []
        for i in range(CHECK_STEPS):
            metrics = self.step_once()
            losses.append(metrics["loss"])
            if i == 0:
                alive = t.state.scene.alive
                self.grad_norms = {k: _masked_norm(v, alive) / (1.0 - rtrain.B1)
                                   for k, v in t.state.adam.mu.items()}
                self.grad_norms[rcogs.CAMERA] = float(torch.linalg.norm(
                    t.state.cam_adam.mu[rcogs.CAMERA].double())) / (1.0 - rtrain.B1)
        start = self._start_scene()
        scene = t.state.scene
        self.change_norms = {k: float(torch.linalg.norm(
            (getattr(scene, k).detach() - start[k]).double())) for k in rcogs.GROUPS}
        self.change_norms[rcogs.CAMERA] = float(torch.linalg.norm(
            t.state.cam_adjust.double()))
        del start
        self.losses = [float(x) for x in losses]
        self.check_views = list(t.datamanager.drawn[:CHECK_STEPS])
        while self.refines == 0 or self.step % int(self.traffic["log_every"]) != 1:
            self.step_once()
        self.run.sync()
        self.setup_parts = {"program_import_s": t0 - t_in, "scene_s": t1 - t0,
                            "targets_s": t2 - t1, "dataset_made_s": self.dataset_made_s,
                            "program_objects_s": t3 - t2,
                            "checked_and_warm_steps_s": time.perf_counter() - t3}

    def _refine(self) -> None:
        """The trainer's refine, counting the lanes it filled (dead before,
        alive after); before it, with ``keep_refine``, the state it starts
        from is kept; after one at step :data:`WRAP_AT`, the step count is
        taken back to :data:`WRAP_TO`."""
        t = self.trainer
        scene = t.state.scene
        before = scene.alive.clone()
        means = scene.means.detach().clone()
        if self.keep_refine:
            self.pre_refine = {
                "params": {k: getattr(scene, k).detach().clone() for k in rcogs.GROUPS},
                "alive": before, "step": self.step + 1,
                "stats": {"grad": t.state.refine.xys_grad_norm.clone(),
                          "vis": t.state.refine.vis_counts.clone(),
                          "max2d": t.state.refine.max_2dsize.clone()},
                "generator": t.generator.get_state()}
        self._trainer_refine()
        new = scene.alive & ~before
        wrote = new | (scene.alive & (scene.means.detach() != means).any(-1))
        self.filled.append(torch.stack([before.sum(), new.sum(), wrote.sum()]))
        if self.step + 1 == WRAP_AT:
            t.state.step.fill_(WRAP_TO)
            self.step = WRAP_TO - 1
            self.wraps += 1

    # -- the measured window --------------------------------------------
    def window(self, seconds: float) -> Dict:
        first = len(self.filled)
        wraps = self.wraps
        out = super().window(seconds)
        rows = [x.tolist() for x in self.filled[first:]]
        self.counts["refine_alive_before"] = [r[0] for r in rows]
        self.counts["refine_filled"] = [r[1] for r in rows]
        self.counts["refine_written"] = [r[2] for r in rows]
        self.counts["step_wraps"] = self.wraps - wraps
        return out

    def _state_counts(self) -> Dict[str, int]:
        out = super()._state_counts()
        out["camera_adjust_norm"] = float(torch.linalg.norm(
            self.trainer.state.cam_adjust.double()))
        return out

    # -- the traced stretch ----------------------------------------------
    def traced(self, record) -> Dict:
        """:meth:`.train.TrainLoop.traced`, each traced view taken with the
        camera its step rendered: the pose, with the error, adjusted by
        the camera group as it stood."""
        every = self.model.refine_every
        steps = int(self.traffic["trace_steps"])
        lead = steps // 2
        while (self.step + lead) % every != 0:
            self.step_once()
        self.run.sync()
        inputs = []

        def body():
            for _ in range(steps):
                with torch.profiler.record_function("gsbench.snapshot"):
                    state = self.trainer.state
                    snap = {k: getattr(state.scene, k).detach().clone()
                            for k in rcogs.GROUPS + ("alive",)}
                    adjust = state.cam_adjust.detach().clone()
                self.spans = True
                try:
                    before = len(self.trainer.datamanager.drawn)
                    self.step_once()
                finally:
                    self.spans = False
                i = self.trainer.datamanager.drawn[before]
                inputs.append((snap, i, adjust[i], int(self.trainer.raster_cfg.bands)))
            self.run.sync()

        trace = record(body)
        views = [(self._view(i, adj), snap, bands) for snap, i, adj, bands in inputs]
        return {"trace": trace, "iterations": steps, "inputs": views,
                "refine_every": every, "sh_degree": int(self.cfg["sh_degree"]),
                "step_ms": self.step_ms, "pixels": self.cap.height * self.cap.width}

    def _view(self, train_index: int, adjust=None) -> rsplat.View:
        cap = self.cap
        c2w = self.poses[int(cap.train[train_index])]
        if adjust is not None:
            with torch.no_grad():
                c2w = rcogs.adjusted_c2w(c2w, adjust)
        return rsplat.View(c2w, cap.fx, cap.fy, cap.cx, cap.cy, cap.height, cap.width)

    # -- the late stretch, after the window --------------------------------
    def _camera_state(self) -> Dict:
        st = self.trainer.state
        return {"adjust": st.cam_adjust.detach().clone(),
                "mu": st.cam_adam.mu[rcogs.CAMERA].clone(),
                "nu": st.cam_adam.nu[rcogs.CAMERA].clone(),
                "count": int(st.cam_adam.count)}

    def check_stretch(self) -> None:
        """Run the loop on to three steps whose third ends a (densifying)
        refine period, keeping the state before them (the scene, both
        Adam groups, the densify statistics, the step, the generator) and
        what the comparison reads: each step's loss, the first step's
        gradient as Adam got it, the changes before the refine, the state
        the refine started from and the one it left."""
        t, every = self.trainer, self.model.refine_every
        while (self.step + CHECK_STEPS) % every != 0:
            self.step_once()
        self.run.sync()
        st = t.state
        alive = st.scene.alive.clone()
        before = {"params": {k: getattr(st.scene, k).detach().clone()
                             for k in rcogs.GROUPS},
                  "mu": {k: st.adam.mu[k].clone() for k in rcogs.GROUPS},
                  "nu": {k: st.adam.nu[k].clone() for k in rcogs.GROUPS},
                  "count": int(st.adam.count), "step": int(st.step),
                  "stats": {"grad": st.refine.xys_grad_norm.clone(),
                            "vis": st.refine.vis_counts.clone(),
                            "max2d": st.refine.max_2dsize.clone()},
                  "camera": self._camera_state(),
                  "generator": t.generator.get_state()}
        before["params"]["alive"] = alive
        first = len(t.datamanager.drawn)
        losses, grad_norms = [], {}
        for i in range(CHECK_STEPS):
            self.keep_refine = i == CHECK_STEPS - 1
            try:
                metrics = self.step_once()
            finally:
                self.keep_refine = False
            losses.append(metrics["loss"])
            if i == 0:
                mu = t.state.adam.mu
                grad_norms = {k: _masked_norm(
                    (mu[k].double() - rtrain.B1 * before["mu"][k].double())
                    / (1.0 - rtrain.B1), alive) for k in rcogs.GROUPS}
                cmu = t.state.cam_adam.mu[rcogs.CAMERA].double()
                grad_norms[rcogs.CAMERA] = float(torch.linalg.norm(
                    (cmu - rtrain.B1 * before["camera"]["mu"].double())
                    / (1.0 - rtrain.B1)))
        pre = self.pre_refine
        change = {k: float(torch.linalg.norm(
            (pre["params"][k] - before["params"][k]).double())) for k in rcogs.GROUPS}
        change[rcogs.CAMERA] = float(torch.linalg.norm(
            (t.state.cam_adjust - before["camera"]["adjust"]).double()))
        scene = t.state.scene
        self.late = {
            "losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change, "alive": scene.alive.clone(),
            "params": {k: getattr(scene, k).detach().clone() for k in rcogs.GROUPS}}
        self.late_before = before
        self.late_views = list(t.datamanager.drawn[first:first + CHECK_STEPS])

    def release(self) -> None:
        super().release()
        self.depths = None

    # -- the comparison with the plain reference -------------------------
    def _targets(self, views: List[int]):
        scene = gscene.draw_scene(self.cfg, self.cap, int(self.cfg["capture_seed"]),
                                  self.device)
        pairs = [target(self.cap, int(self.cap.train[i]), scene, self.cfg)
                 for i in views]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def reference_readings(self, tf32: bool = False, fault: str = "",
                           late: bool = False) -> Dict:
        """The plain reference's three steps of the start or, with
        ``late``, of the late stretch (with its refine, and the refine of
        the program's own state before it), in float32 or as the TF32
        control, or with one of :data:`gsbench.reference.cogs.FAULTS`
        planted."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        n = len(self.cap.train)
        if late:
            b = self.late_before
            params = {k: v.clone() for k, v in b["params"].items()}
            stats = {k: v.clone() for k, v in b["stats"].items()}
            camera = dict(b["camera"])
            gen.set_state(b["generator"])
            views_i, first, moments, count = (self.late_views, b["step"],
                                              (b["mu"], b["nu"]), b["count"])
        else:
            params = self._start_scene()
            c = params["alive"].numel()
            stats = {k: torch.zeros(c, device=dev) for k in ("grad", "vis", "max2d")}
            zero = torch.zeros((n, 6), device=dev)
            camera = {"adjust": zero, "mu": zero, "nu": zero, "count": 0}
            gen.manual_seed(self.run.derived_seed(2))
            views_i, first, moments, count = (self.check_views,
                                              int(cfg["start_step"]), None, 0)
        targets, depths = self._targets(views_i)
        ar = Arith(tf32=tf32)
        return rcogs.run_steps(params, stats, camera, [self._view(i) for i in views_i],
                               views_i, targets, depths, gen, first,
                               int(cfg["sh_degree"]), int(cfg["bands"]), n, ar,
                               fault, moments, count)

    def sound_refine(self, pre: Dict) -> Dict:
        """The reference's refine, in float32 with no fault, of the state
        ``pre`` that a refine started from."""
        return rcogs.refine_from(pre, len(self.cap.train),
                                 max(self.cap.height, self.cap.width))

    def program_readings(self, late: bool = False) -> Dict:
        if late:
            return self.late
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}

    @staticmethod
    def compare(got: Dict, ref: Dict, prefix: str = "",
                sound: Dict = None) -> Dict[str, float]:
        """:meth:`.train.TrainLoop.compare` over the seven groups, and
        after a refine ``alive_lanes``, the lanes alive on one side only,
        and ``refine_gap``: by the worst group, the norm of the difference
        between the parameters ``got`` holds after its refine and those
        ``sound`` (the reference's refine of the state ``got``'s refine
        started from) holds, over the norm of the lanes ``sound`` wrote
        (nothing else differs where both refines are right)."""
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        out = {prefix + "loss_gap": loss}
        med_grad = float(np.median(list(ref["grad_norms"].values())))
        groups = [k for k in GROUPS if ref["grad_norms"][k] >= 1e-3 * med_grad]
        for key, name in (("grad_norms", "grad_gap"), ("change_norms", "change_gap")):
            med = float(np.median(list(ref[key].values())))
            out[prefix + name] = max(abs(got[key][k] - ref[key][k]) / max(ref[key][k], med)
                                     for k in groups)
        if sound is not None:
            out[prefix + "alive_lanes"] = float((got["alive"] != ref["alive"]).sum())
            out[prefix + "refine_gap"] = max(
                float(torch.linalg.norm((got["params"][k] - sound["params"][k]).double()))
                / max(float(torch.linalg.norm(sound["params"][k][sound["slot"]].double())),
                      1e-30) for k in rcogs.GROUPS)
        return out

    def refine_detail(self, ref: Dict, sound: Dict) -> Dict:
        """What the late refine's numbers rest on: the lanes the
        reference's own refine wrote, split, copied and culled, and the
        lanes its refine of the program's state wrote."""
        r = ref["refine"]
        return {"written": int(r["slot"].numel()), "split": r["split"],
                "dup": r["dup"], "culled": r["cull"],
                "written_from_program_state": int(sound["slot"].numel())}

    def verify(self) -> Dict:
        ref = self.reference_readings()
        numbers = self.compare(self.program_readings(), ref)
        del ref
        late = self.reference_readings(late=True)
        sound = self.sound_refine(self.pre_refine)
        numbers.update(self.compare(self.program_readings(True), late, LATE, sound))
        return {"numbers": numbers, "attempted": 2 * CHECK_STEPS,
                "detail": self.refine_detail(late, sound)}

    def readings(self, controls: bool) -> Dict:
        """The readings the limits are set from (``gsbench.control_cogs``):
        the program against the reference, and with ``controls`` the
        reference in the program's place as the TF32 control and with each
        planted fault (:data:`gsbench.reference.cogs.FAULTS`)."""
        ref = self.reference_readings()
        late = self.reference_readings(late=True)
        sound = self.sound_refine(self.pre_refine)
        out = {"program": self.compare(self.program_readings(), ref)}
        out["program"].update(self.compare(self.program_readings(True), late, LATE, sound))
        out["detail"] = self.refine_detail(late, sound)
        if controls:
            for name, kw in [("tf32", {"tf32": True})] + [
                    (f, {"fault": f}) for f in rcogs.FAULTS]:
                out[name] = self.compare(self.reference_readings(**kw), ref)
                got = self.reference_readings(late=True, **kw)
                out[name].update(self.compare(got, late, LATE,
                                              self.sound_refine(got["pre_refine"])))
            out["reference"] = {k: ref[k] for k in ("losses", "grad_norms", "change_norms")}
            out["program_detail"] = self.program_readings()
        return out


DRIVER = TrainCogs
