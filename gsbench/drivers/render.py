"""Render requests as traffic: a closed loop of ``clients`` = 1, as the
viewer, gs-render and gs-eval's host loop each wait for their frame. Each
request is ``Renderer.get_output_from_pose`` at the capture's size, its
rgb, depth and accumulation returned to the host as numpy arrays. The
poses cycle over the capture's eval views and ``orbit`` poses on its
middle ring, interleaved, in an order drawn from the seed.

The renderer is the program's ``Renderer``, built by its own constructor
around the drawn scene: its checkpoint loaders are handed the scene and
the metadata a checkpoint of the configuration carries (``isect_capacity``,
``bands``, ``sh_degree``), so that it picks its raster shape as it does
for a file.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from gsbench import scene as gscene
from gsbench.reference import splat as rsplat
from gsbench.reference.precision import Arith, strict_f32

SCENE_FIELDS = ("means", "scales", "quats", "features_dc", "features_rest",
                "opacities", "alive")

class RenderLoop:
    """One render cell: ``setup``, ``window``, ``traced``, ``verify``."""

    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.traffic = run.traffic
        self.device = run.device
        self.spans = False

    def setup(self) -> None:
        t_in = time.perf_counter()
        from gstk_torch.core.gaussians import GaussianScene
        from gstk_torch.render import renderer as rmod

        cfg, dev = self.cfg, self.device
        t0 = time.perf_counter()
        cap = self.cap = gscene.capture(cfg, dev)
        scene = GaussianScene(**gscene.draw_scene(cfg, cap, self.run.scene_seed, dev))
        meta = {"isect_capacity": int(cfg["isect_capacity"]),
                "bands": int(cfg["bands"]), "sh_degree": int(cfg["sh_degree"])}
        with mock.patch.object(rmod, "load_scene", lambda path, device: (scene, 0)), \
                mock.patch.object(rmod, "peek_meta", lambda path: meta):
            self.renderer = rmod.Renderer("scene.ckpt.npz", device=dev)
        poses = [cap.poses[int(i)].cpu().numpy() for i in cap.eval]
        n_orbit = int(self.traffic["orbit"])
        orbit = [gscene.orbit_pose(2 * math.pi * k / n_orbit, cap)
                 for k in range(n_orbit)]
        mixed = [p for pair in zip(poses, orbit) for p in pair]
        mixed += poses[len(orbit):] + orbit[len(poses):]
        order = np.random.default_rng(self.run.derived_seed(1)).permutation(len(mixed))
        self.poses = [mixed[i] for i in order]
        rng = np.random.default_rng(self.run.derived_seed(3))
        self.sampled = set(rng.choice(len(self.poses), int(self.traffic["checked"]),
                                      replace=False).tolist())
        self.kept: Dict[int, Dict[str, np.ndarray]] = {}
        self.next = 0
        t1 = time.perf_counter()
        for _ in range(int(self.traffic["warmup"])):
            self.request()
        self.setup_parts = {"program_import_s": t0 - t_in,
                            "scene_and_renderer_s": t1 - t0,
                            "warm_requests_s": time.perf_counter() - t1}

    def request(self) -> float:
        """Serve the next pose; returns its latency in seconds."""
        cap = self.cap
        k = self.next % len(self.poses)
        self.next += 1
        span = (torch.profiler.record_function("gsbench.request") if self.spans
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            out = self.renderer.get_output_from_pose(
                self.poses[k], cap.fx, cap.fy, cap.cx, cap.cy, cap.height,
                cap.width)
        dt = time.perf_counter() - t0
        if k in self.sampled:
            self.kept[k] = out
        return dt

    def window(self, seconds: float) -> Dict:
        lat: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self.request())
        elapsed = time.perf_counter() - t0
        self.latencies = lat
        self.request_ms = elapsed / len(lat) * 1e3
        p95 = float(np.percentile(np.asarray(lat) * 1e3, 95))
        self.counts = {"requests": len(lat), "window_s": elapsed,
                       "median_ms": float(np.median(lat) * 1e3),
                       "p95_samples_beyond": int(np.ceil(len(lat) * 0.05))}
        return {"render_fps": len(lat) / elapsed, "render_p95_ms": p95}

    def traced(self, record) -> Dict:
        n = int(self.traffic["trace_requests"])
        poses = []

        def body():
            self.spans = True
            try:
                for _ in range(n):
                    poses.append(self.poses[self.next % len(self.poses)])
                    self.request()
            finally:
                self.spans = False
            self.run.sync()

        trace = record(body)
        scene = self.renderer.scene
        snap = {k: getattr(scene, k).detach() for k in SCENE_FIELDS}
        return {"trace": trace, "iterations": n,
                "inputs": [(self._view(p), snap, int(self.cfg["bands"])) for p in poses],
                "sh_degree": int(self.cfg["sh_degree"]),
                "step_ms": self.request_ms,
                "pixels": self.cap.height * self.cap.width}

    def _view(self, c2w) -> rsplat.View:
        cap = self.cap
        return rsplat.View(torch.as_tensor(c2w, device=self.device), cap.fx, cap.fy,
                           cap.cx, cap.cy, cap.height, cap.width)

    def check_stretch(self) -> None:
        """Nothing to run on: the window's own sampled requests are what is
        compared."""

    def release(self) -> None:
        self.renderer = None

    def reference_outputs(self, k: int, tf32: bool = False,
                          fault: str = "") -> Dict[str, np.ndarray]:
        """The plain reference's render of request pose ``k``, in float32
        or as the TF32 control; ``fault`` "half" leaves the bottom half of
        the image unrendered, "altered" adds 0.02 to the colour of the tile
        row at the image's middle."""
        params = self._params
        bg = torch.zeros(3, device=self.device)  # the Renderer's default
        with strict_f32():
            out = rsplat.render(params, self._view(self.poses[k]),
                                int(self.cfg["sh_degree"]), bg,
                                int(self.cfg["bands"]), Arith(tf32=tf32))
        got = {"rgb": out["rgb"].cpu().numpy(), "depth": out["depth"].cpu().numpy(),
               "accumulation": out["alpha"].cpu().numpy()}
        h = self.cap.height
        if fault == "half":
            got["rgb"][h // 2:] = 0.0
            got["accumulation"][h // 2:] = 0.0
            got["depth"][h // 2:] = 0.0
        if fault == "altered":
            got["rgb"][h // 2:h // 2 + rsplat.BLOCK] += 0.02
        return got

    @staticmethod
    def compare(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
        """The numbers compared for one request: the mean absolute error of
        rgb and of the accumulation, and of the depth weighted by the
        reference's accumulation, over its weighted mean depth."""
        a = ref["accumulation"]
        depth = (np.abs(got["depth"] - ref["depth"]) * a).mean() / max(
            float((ref["depth"] * a).mean()), 1e-12)
        return {"rgb_mae": float(np.abs(got["rgb"] - ref["rgb"]).mean()),
                "accumulation_mae": float(np.abs(got["accumulation"] - a).mean()),
                "depth_wmae": float(depth)}

    def verify(self) -> Dict:
        self._params = gscene.draw_scene(self.cfg, self.cap, self.run.scene_seed, self.device)
        worst: Dict[str, float] = {}
        for k in sorted(self.kept):
            nums = self.compare(self.kept[k], self.reference_outputs(k))
            for name, v in nums.items():
                worst[name] = max(worst.get(name, 0.0), v)
        return {"numbers": worst, "attempted": len(self.kept), "detail": {}}


DRIVER = RenderLoop
