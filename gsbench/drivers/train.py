"""The trainer's loop as traffic: one view a step from the device cache, in
the datamanager's shuffled order, the method's random background, a
refine every ``refine_every`` steps and one host fetch of the step's
metrics every ``log_every`` steps (with the trainer's growth policy on
them), in ``Trainer.train``'s order. Checkpoints and evals are not in the
traffic.

The program's own objects do the work: a ``Trainer`` whose scene, state,
raster shape and device cache are the cell's inputs (in place of
``Trainer.setup``, which reads a dataset from disk), and its
``_step_fn``, ``_train_inputs``, ``_refine``, ``_drain_isect_window`` and
``_maybe_grow`` per iteration, as ``Trainer.train`` calls them
(``gsbench/tests/test_gsbench_extend.py`` fails when the two differ). The
scene is the capture's own (:func:`gsbench.scene.trained_scene`), so the
state stays put over a window.

Two stretches of that same loop are compared with the plain reference
(:mod:`gsbench.reference.train`):

* **the start**: set-up runs the first three steps from the scene drawn
  from the seed (step ``start_step``, fresh Adam moments) and keeps each
  step's loss, the first gradient as Adam got it (its first moment over
  1 - beta1) and the parameters' change after the third step; the
  reference follows them from the same draw;
* **the late stretch** (:meth:`TrainLoop.check_stretch`): after the
  window, and after the traced stretch, the loop runs on to three steps
  whose third ends a refine period; the state before them (scene, Adam's
  moments and count, the step, the background generator) is kept, and
  the reference follows the three steps and the refine's cull from it.
  Here the reference starts from the program's own state, since a state
  of the window's length can only be reached by running it; the start
  checks the stage this skips.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from gsbench import scene as gscene
from gsbench.reference import splat as rsplat
from gsbench.reference import train as rtrain
from gsbench.reference.precision import Arith, strict_f32

GROUPS = rtrain.GROUPS
CHECK_STEPS = 3
LATE = "late_"  # the late stretch's numbers


class Views:
    """The datamanager's draw: a random unseen train view, reshuffled each
    epoch (``FullImageDatamanager.next_train``), from the run's seed."""

    def __init__(self, n: int, seed: int, image_size):
        self.num_train_global = n
        self.image_size = image_size
        self._rng = np.random.default_rng(seed)
        self._unseen: List[int] = []
        self.drawn: List[int] = []

    def next_train(self):
        if not self._unseen:
            self._unseen = list(self._rng.permutation(self.num_train_global))
        i = int(self._unseen.pop())
        self.drawn.append(i)
        return i, None


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class TrainLoop:
    """One train cell: ``setup``, ``window``, ``traced``, ``verify``."""

    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.traffic = run.traffic
        self.device = run.device
        self.spans = False

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        t_in = time.perf_counter()
        from gstk_torch.core.cameras import Camera
        from gstk_torch.core.gaussians import GaussianScene
        from gstk_torch.models.vanilla import VanillaConfig
        from gstk_torch.ops.rasterize import RasterizeConfig
        from gstk_torch.train.step import init_train_state
        from gstk_torch.train.trainer import Trainer, TrainerConfig

        cfg, dev = self.cfg, self.device
        t0 = time.perf_counter()
        cap = self.cap = gscene.capture(cfg, dev)
        tensors = self._start_scene()
        self.run.sync()
        t1 = time.perf_counter()
        self.targets, self.dataset_made_s = gscene.train_targets(
            cap, cfg, self.run.root / "build" / "gsbench")
        self.run.sync()
        t2 = time.perf_counter()
        self.model = VanillaConfig()
        tcfg = TrainerConfig(
            max_num_iterations=int(cfg["max_num_iterations"]),
            log_every=int(self.traffic["log_every"]),
            isect_capacity=int(cfg["isect_capacity"]),
            max_capacity=int(cfg["capacity"]), model=self.model,
            steps_per_save=0, steps_per_eval_image=0,
            steps_per_eval_all_images=0,
        )
        t = self.trainer = Trainer(tcfg, device=dev)
        t.datamanager = Views(len(cap.train), self.run.derived_seed(1),
                              (cap.height, cap.width))
        t.state = init_train_state(GaussianScene(**tensors))
        t.state.step.fill_(int(cfg["start_step"]))
        t.raster_cfg = RasterizeConfig(chunk_size=tcfg.raster_chunk,
                                       isect_capacity=int(cfg["isect_capacity"]),
                                       bands=int(cfg["bands"]))
        t.generator = torch.Generator(device=dev)
        t.generator.manual_seed(self.run.derived_seed(2))
        t.step_generator = t.generator
        n = len(cap.train)
        full = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)
        cams = Camera(fx=full(cap.fx), fy=full(cap.fy), cx=full(cap.cx),
                      cy=full(cap.cy), c2w=cap.poses[torch.as_tensor(cap.train)])
        t._dev_cache = {1: (cams, self.targets, None, None, None, None)}
        self.step = int(cfg["start_step"])
        self.refines = 0
        t3 = time.perf_counter()

        # the checked steps: the loop's own first steps
        losses = []
        for i in range(CHECK_STEPS):
            metrics = self.step_once()
            losses.append(metrics["loss"])
            if i == 0:
                alive = t.state.scene.alive
                self.grad_norms = {
                    k: float(torch.linalg.norm(torch.where(
                        alive.reshape(alive.shape + (1,) * (v.ndim - 1)),
                        v, 0.0).double()) / (1.0 - rtrain.B1))
                    for k, v in t.state.adam.mu.items()}
        start = self._start_scene()
        scene = t.state.scene
        self.change_norms = {k: float(torch.linalg.norm(
            (getattr(scene, k).detach() - start[k]).double())) for k in GROUPS}
        del start
        self.losses = [float(x) for x in losses]
        self.check_views = list(t.datamanager.drawn[:CHECK_STEPS])
        # warm-up: on to the first refine and one fetch after it, so that
        # every call of the window has run once
        while self.refines == 0 or self.step % int(self.traffic["log_every"]) != 1:
            self.step_once()
        self.run.sync()
        self.setup_parts = {"program_import_s": t0 - t_in, "scene_s": t1 - t0,
                            "targets_s": t2 - t1, "dataset_made_s": self.dataset_made_s,
                            "program_objects_s": t3 - t2,
                            "checked_and_warm_steps_s": time.perf_counter() - t3}

    def _start_scene(self) -> Dict[str, torch.Tensor]:
        return gscene.trained_scene(self.cfg, self.cap, self.run.scene_seed, self.device)

    def step_once(self) -> Dict[str, torch.Tensor]:
        """One iteration of ``Trainer.train``'s loop."""
        from gstk_torch.models.vanilla import downscale_factor

        t, step, model = self.trainer, self.step, self.model
        with _span("gsbench.step", self.spans):
            d = downscale_factor(model, step)
            h, w = self.cap.height // d, self.cap.width // d
            fn = t._step_fn(h, w, t._sh_degree(step),
                            model.use_scale_regularization and step % 10 == 0)
            cam_idx, frame = t.datamanager.next_train()
            inputs = t._train_inputs(cam_idx, frame, d)
            t.state, metrics = fn(t.state, *inputs[:2], t.step_generator,
                                  *inputs[2:],
                                  camera_index=t._camera_index(cam_idx))
            t._isect_window.append(metrics["num_intersects"])
        if (step + 1) % model.refine_every == 0:
            with _span("gsbench.refine", self.spans):
                t._refine()
            self.refines += 1
        if step % int(self.traffic["log_every"]) == 0:
            with _span("gsbench.fetch", self.spans):
                host = {k: float(v) for k, v in metrics.items()}
                t._maybe_grow(t._drain_isect_window(host), step)
            self.last_fetch = host
        self.step += 1
        return metrics

    def _state_counts(self) -> Dict[str, int]:
        t = self.trainer
        return {"alive": int(t.state.scene.num_alive),
                "intersections_per_band": int(self.last_fetch["num_intersects"]),
                "bands": int(t.raster_cfg.bands),
                "isect_capacity": int(t.raster_cfg.isect_capacity),
                "step": self.step}

    # -- the measured window --------------------------------------------
    def window(self, seconds: float) -> Dict:
        sync = self.run.sync
        self.counts_start = self._state_counts()
        refines0 = self.refines
        sync()
        n, t0 = 0, time.perf_counter()
        marks = []
        while time.perf_counter() - t0 < seconds:
            self.step_once()
            n += 1
            if n % 100 == 0:
                marks.append(time.perf_counter())
        sync()
        elapsed = time.perf_counter() - t0
        self.step_ms = elapsed / n * 1e3
        self.counts = {"steps": n, "refines": self.refines - refines0,
                       "window_s": elapsed, "start": self.counts_start,
                       "end": self._state_counts(),
                       "ms_per_step_by_100": [
                           (b - a) * 10.0 for a, b in zip([t0] + marks, marks)]}
        return {"train_step_ms": self.step_ms}

    # -- the traced stretch ----------------------------------------------
    def traced(self, record) -> Dict:
        """``record(body)`` traces ``body``; the stretch holds
        ``trace_steps`` iterations with a refine among them. Returns what
        the metric readers need."""
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
                    scene = self.trainer.state.scene
                    snap = {k: getattr(scene, k).detach().clone()
                            for k in GROUPS + ("alive",)}
                self.spans = True
                try:
                    before = len(self.trainer.datamanager.drawn)
                    self.step_once()
                finally:
                    self.spans = False
                inputs.append((snap, self.trainer.datamanager.drawn[before],
                               int(self.trainer.raster_cfg.bands)))
            self.run.sync()

        trace = record(body)
        views = [(self._view(i), snap, bands) for snap, i, bands in inputs]
        return {"trace": trace, "iterations": steps, "inputs": views,
                "refine_every": every, "sh_degree": int(self.cfg["sh_degree"]),
                "step_ms": self.step_ms, "pixels": self.cap.height * self.cap.width}

    def _view(self, train_index: int) -> rsplat.View:
        cap = self.cap
        return rsplat.View(cap.poses[int(cap.train[train_index])], cap.fx,
                           cap.fy, cap.cx, cap.cy, cap.height, cap.width)

    # -- the late stretch, after the window --------------------------------
    def check_stretch(self) -> None:
        """Run the loop on to three steps whose third ends a refine period,
        keeping the state before them and what the comparison reads:
        each step's loss, the first step's gradient as Adam got it (from
        its first moment before and after), the parameters' change and
        the alive lanes after the refine."""
        t, every = self.trainer, self.model.refine_every
        while (self.step + CHECK_STEPS) % every != 0:
            self.step_once()
        self.run.sync()
        st = t.state
        alive = st.scene.alive.clone()
        before = {"params": {k: getattr(st.scene, k).detach().clone()
                             for k in GROUPS},
                  "mu": {k: st.adam.mu[k].clone() for k in GROUPS},
                  "nu": {k: st.adam.nu[k].clone() for k in GROUPS},
                  "count": int(st.adam.count), "step": int(st.step),
                  "generator": t.step_generator.get_state()}
        before["params"]["alive"] = alive
        first = len(t.datamanager.drawn)
        losses, grad_norms = [], {}
        for i in range(CHECK_STEPS):
            metrics = self.step_once()
            losses.append(metrics["loss"])
            if i == 0:
                mu = t.state.adam.mu
                grad_norms = {k: float(torch.linalg.norm(torch.where(
                    alive.reshape(alive.shape + (1,) * (mu[k].ndim - 1)),
                    (mu[k].double() - rtrain.B1 * before["mu"][k].double())
                    / (1.0 - rtrain.B1), 0.0))) for k in GROUPS}
        scene = t.state.scene
        self.late = {
            "losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": {k: float(torch.linalg.norm(
                (getattr(scene, k).detach() - before["params"][k]).double()))
                for k in GROUPS},
            "alive": scene.alive.clone(),
            "opacities": scene.opacities.detach()[:, 0].clone()}
        self.late_before = before
        self.late_views = list(t.datamanager.drawn[first:first + CHECK_STEPS])

    def release(self) -> None:
        self.trainer = None
        self.targets = None

    # -- the comparison with the plain reference -------------------------
    def _targets(self, views: List[int]) -> List[torch.Tensor]:
        scene = gscene.draw_scene(self.cfg, self.cap, int(self.cfg["capture_seed"]),
                                  self.device)
        return [gscene.target(self.cap, int(self.cap.train[i]), scene,
                              *gscene.target_noise(self.cfg)) for i in views]

    def reference_readings(self, tf32: bool = False, fault: str = "",
                           late: bool = False) -> Dict:
        """The plain reference's three steps of the start (from the seed's
        scene) or, with ``late``, of the late stretch (from the state kept
        before it), in float32 (``tf32=False``) or as the TF32 control, or
        with one of :data:`gsbench.reference.train.FAULTS` planted."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        if late:
            b = self.late_before
            params = {k: v.clone() for k, v in b["params"].items()}
            gen.set_state(b["generator"])
            views_i, first, moments, count = (self.late_views, b["step"],
                                              (b["mu"], b["nu"]), b["count"])
        else:
            params = self._start_scene()
            gen.manual_seed(self.run.derived_seed(2))
            views_i, first, moments, count = (self.check_views,
                                              int(cfg["start_step"]), None, 0)
        backgrounds = [torch.rand(3, generator=gen, device=dev) for _ in views_i]
        targets = self._targets(views_i)
        with strict_f32():
            return rtrain.run_steps(params, [self._view(i) for i in views_i],
                                    targets, backgrounds, first,
                                    int(cfg["sh_degree"]), int(cfg["bands"]),
                                    Arith(tf32=tf32), fault, moments, count)

    def program_readings(self, late: bool = False) -> Dict:
        if late:
            return self.late
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}

    @staticmethod
    def compare(got: Dict, ref: Dict, prefix: str = "") -> Dict[str, float]:
        """The numbers compared: the worst step's relative loss gap, and by
        the worst group the gap of the first gradient's norm and of the
        change's norm, each against the larger of that group's reference
        norm and the median group's. A group whose reference gradient is
        under a thousandth of the median group's moves by round-off alone
        under Adam and is left out of both. Where both sides end with the
        alive lanes (the late stretch, whose last step ends a refine
        period), also the lanes alive on one side only: Adam turns a
        compositing cutoff that round-off flips into a step of a whole
        learning rate, so a lane near the cull's threshold may land on
        either side of it."""
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        out = {prefix + "loss_gap": loss}
        med_grad = float(np.median(list(ref["grad_norms"].values())))
        groups = [k for k in GROUPS if ref["grad_norms"][k] >= 1e-3 * med_grad]
        for key, name in (("grad_norms", "grad_gap"), ("change_norms", "change_gap")):
            med = float(np.median(list(ref[key].values())))
            out[prefix + name] = max(abs(got[key][k] - ref[key][k]) / max(ref[key][k], med)
                                     for k in groups)
        if "alive" in got and "alive" in ref:
            out[prefix + "cull_lanes"] = float((got["alive"] != ref["alive"]).sum())
        return out

    def cull_detail(self, ref: Dict) -> Dict:
        """What the late cull's number rests on: the lanes the reference
        culled, and the widest gap of an opacity logit over the lanes
        alive before the stretch."""
        got, before = self.late, self.late_before["params"]["alive"]
        return {"culled": int((before & ~ref["alive"]).sum()),
                "logit_gap": float((got["opacities"] - ref["opacities"])[before]
                                   .abs().max())}

    def verify(self) -> Dict:
        numbers, detail = {}, {}
        for late, prefix in ((False, ""), (True, LATE)):
            ref = self.reference_readings(late=late)
            numbers.update(self.compare(self.program_readings(late), ref, prefix))
            if late:
                detail = self.cull_detail(ref)
        return {"numbers": numbers, "attempted": 2 * CHECK_STEPS, "detail": detail}


DRIVER = TrainLoop
