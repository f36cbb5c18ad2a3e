"""One :func:`gstk_torch.train.strategy.refine` pass at training operating
points (port of ``tools/bench_refine.py``).

The inputs are the reference's: at each capacity in ``--caps`` (2^20 and
2^21), n = 0.9 capacity live Gaussians from ``default_rng(0)`` (uniform
points in [-3, 3]^3 and rgb), uniform screen-gradient norms in [0, 1e-3),
visibility counts of 1 and uniform 2-D sizes in [0, 0.1), refined at step
5000 of a run of 200 views at 800 px with ``VanillaConfig(warmup_length=0,
refine_every=100, reset_alpha_every=30)``. gstk_tpu's ``init_scene``
draws the quaternions from ``jax.random.PRNGKey(0)``; here they come from
a seed-0 ``torch.Generator``, and the split samples' noise from a seed-1
one.

``refine`` updates its state in place, so each timed call refines a fresh
device copy of the same state (copied outside the timing) and is
synchronized on both sides. It prints the median and mean ms over
``--iters`` calls after one warm-up, the split / duplicate / cull counts,
and the device peak above the state (``max_memory_allocated`` after
``reset_peak_memory_stats``, less the memory held before the call).

Usage (on the card):
  python -m gstk_torch.tools.bench_refine [--caps 1048576 2097152]
CPU rehearsal (one call, untimed):
  python -m gstk_torch.tools.bench_refine --device cpu --caps 4096
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict

import numpy as np
import torch

from gstk_torch import resolve_device
from gstk_torch.core.gaussians import GaussianScene, init_scene
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.tools import card
from gstk_torch.train.optim import AdamState, init_adam
from gstk_torch.train.strategy import RefineState, refine

STEP, NUM_TRAIN, IMG_SIZE = 5000, 200, 800
CONFIG = VanillaConfig(warmup_length=0, refine_every=100, reset_alpha_every=30)


def refine_draws(cap: int) -> Dict[str, np.ndarray]:
    """The reference's numpy draws at capacity ``cap``, in its order."""
    n = int(cap * 0.9)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    grad = rng.uniform(0, 1e-3, cap).astype(np.float32)
    size = rng.uniform(0, 0.1, cap).astype(np.float32)
    return {"pts": pts, "rgb": rgb, "xys_grad_norm": grad, "max_2dsize": size}


def refine_inputs(cap: int, device) -> tuple:
    """(scene, adam, refine state, noise) at capacity ``cap`` on ``device``."""
    d = refine_draws(cap)
    scene = init_scene(torch.Generator().manual_seed(0), cap,
                       (d["pts"], d["rgb"]), sh_degree=3, device=device)
    rs = RefineState(
        xys_grad_norm=torch.from_numpy(d["xys_grad_norm"]).to(device),
        vis_counts=torch.ones(cap, dtype=torch.float32, device=device),
        max_2dsize=torch.from_numpy(d["max_2dsize"]).to(device))
    noise = torch.randn((CONFIG.n_split_samples, cap, 3),
                        generator=torch.Generator().manual_seed(1)).to(device)
    return scene, init_adam(scene.params()), rs, noise


def copy_state(scene: GaussianScene, adam: AdamState, rs: RefineState):
    """A fresh copy (``refine`` updates the scene and moments in place)."""
    clone = lambda t: t.detach().clone()
    s = GaussianScene(**{k: clone(v) for k, v in scene.params().items()},
                      alive=clone(scene.alive))
    a = AdamState(count=clone(adam.count),
                  mu={k: clone(v) for k, v in adam.mu.items()},
                  nu={k: clone(v) for k, v in adam.nu.items()})
    return s, a, RefineState(*(clone(x) for x in rs))


def run_refine(inputs: tuple):
    """One refine of a copy of ``inputs``: (scene, adam, refine state, info)."""
    scene, adam, rs, noise = inputs
    s, a, r = copy_state(scene, adam, rs)
    return refine(s, a, r, STEP, CONFIG, NUM_TRAIN, IMG_SIZE, noise=noise)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("bench_refine")
    ap.add_argument("--caps", type=int, nargs="+", default=[1 << 20, 1 << 21])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu refines once, "
                         "untimed)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card_run = dev.type == "cuda"
    res: Dict = {"caps": {}}
    if card_run:
        res["card"] = card()
        print(res["card"], flush=True)
    for cap in args.caps:
        inputs = refine_inputs(cap, dev)
        *_, info = run_refine(inputs)
        entry = {"info": {k: int(v) for k, v in info.items()}}
        if card_run:
            ms, peak = [], 0
            for _ in range(args.iters):
                state = copy_state(*inputs[:3])
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = refine(*state, STEP, CONFIG, NUM_TRAIN, IMG_SIZE,
                             noise=inputs[3])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                peak = max(peak, torch.cuda.max_memory_allocated() - held)
                del state, out
            entry.update(
                median_ms=statistics.median(ms), mean_ms=statistics.mean(ms),
                min_ms=min(ms), calls=len(ms),
                peak_above_state_mib=peak / 2**20)
        res["caps"][cap] = entry
        print(f"refine cap={cap}: " + (
            f"{entry['median_ms']:.2f} ms median, {entry['mean_ms']:.2f} mean "
            f"(synchronized, {args.iters} calls), peak "
            f"{entry['peak_above_state_mib']:.1f} MiB above the state; "
            if card_run else "") + f"{entry['info']}", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
