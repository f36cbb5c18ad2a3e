"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of a run is driven at a
tiny size on the CPU, and each fault a cell can have is planted in the
program (one chip: no exchange between chips to leave out):

* train cells: a step that returns its state unchanged (Adam leaves the
  parameters and moments as they were), half of the batch left out (the
  loss over the top half of the pixels, the mean over the rest), an
  answer altered where it is produced (0.02 added to the rendered colour
  of a tile row), and a wrong cull in the refine (it culls nothing, or
  the lane beside each lane it should cull), for which the scene holds
  Gaussians under the cull's opacity;
* the render cell: half of the image left out, and the same alteration
  of the served colour.
"""

from __future__ import annotations

import json

import pytest
import torch

from gsbench import run as grun
from gsbench.tests.tiny import REPO, tiny_root

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
TRAIN = [w["name"] for w in MANIFEST["workloads"] if w["traffic"] == "train_loop"]
RENDER = [w["name"] for w in MANIFEST["workloads"] if w["traffic"] == "render_closed_loop"]


def _altered(out):
    rgb = out["rgb"]
    rows = torch.arange(rgb.shape[0]) - rgb.shape[0] // 2
    return dict(out, rgb=rgb + ((rows >= 0) & (rows < 16))[:, None, None] * 0.02)


def _plant(monkeypatch, fault: str) -> None:
    import gstk_torch.render.renderer as renderer
    import gstk_torch.train.step as step
    import gstk_torch.train.strategy as strategy

    if fault == "unchanged":
        def adam_step(params, grads, state, *args, **kwargs):
            return state._replace(count=state.count + 1)
        monkeypatch.setattr(step, "adam_step", adam_step)
    elif fault == "half":
        real = step.rgb_loss

        def rgb_loss(pred, gt, *args, **kwargs):
            h = pred.shape[0] // 2
            return real(pred[:h], gt[:h], *args, **kwargs)
        monkeypatch.setattr(step, "rgb_loss", rgb_loss)
    elif fault == "altered":
        real = step.render_scene
        monkeypatch.setattr(step, "render_scene", lambda *a, **k: _altered(real(*a, **k)))
    elif fault == "cull_none":
        monkeypatch.setattr(strategy, "_cull_mask",
                            lambda scene, *a, **k: torch.zeros_like(scene.alive))
    elif fault == "cull_shifted":
        real = strategy._cull_mask
        monkeypatch.setattr(strategy, "_cull_mask", lambda scene, *a, **k: torch.roll(
            real(scene, *a, **k), 1) & scene.alive)
    elif fault == "render_half":
        real = renderer.render_scene

        def render_scene(*a, **k):
            out = dict(real(*a, **k))
            h = out["rgb"].shape[0] // 2
            for key in ("rgb", "alpha", "depth"):
                out[key] = out[key].clone()
                out[key][h:] = 0.0
            return out
        monkeypatch.setattr(renderer, "render_scene", render_scene)
    elif fault == "render_altered":
        real = renderer.render_scene
        monkeypatch.setattr(renderer, "render_scene",
                            lambda *a, **k: _altered(real(*a, **k)))


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN
                                        for f in ("unchanged", "half", "altered",
                                                  "cull_none", "cull_shifted")]
                         + [(c, f) for c in RENDER
                            for f in ("render_half", "render_altered")])
def test_a_broken_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    torch.set_num_threads(4)
    # some Gaussians under the cull's opacity (0.1), for the refine to cull
    root = tiny_root(tmp_path, scene={"opacity_min": 0.01})
    args = ["--workload", cell, "--seed", "11", "--seconds", "0.5", "--trace", "0"]
    assert grun.run(args, root=root, allow_cpu=True)["correct"] is True
    _plant(monkeypatch, fault)
    res = grun.run(args, root=root, allow_cpu=True)
    assert res["correct"] is False, res["checks"]
