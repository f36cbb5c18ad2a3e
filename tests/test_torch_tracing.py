"""Layer spans (``gstk_torch/utils/profiler.py::timer``) at the port's
layer boundaries, on the CPU at 64x64 with the plain backend.

With no profiler recording, a span enters no range and
still adds to ``PROFILER``'s running mean. Under a CPU ``torch.profiler``
each entry point's ``gstk.*`` ranges are host operations of the trace
and nest as the layers do: a train step
holds ``project``, ``raster``, ``loss``, ``backward`` and ``update`` in
that order (a micro-batched one the first four once per camera), a refine
is one ``refine`` span, and a render request is ``project``, ``raster``
and ``copy_out``.
"""

from __future__ import annotations

import collections
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import init_scene
from gstk_torch.models.vanilla import VanillaConfig
from gstk_torch.ops.rasterize import RasterizeConfig
from gstk_torch.render.renderer import Renderer
from gstk_torch.train import step as tstep
from gstk_torch.train.checkpoint import save_scene
from gstk_torch.train.optim import OptimizerConfig
from gstk_torch.train.trainer import Trainer, TrainerConfig
from gstk_torch.utils import profiler

torch.set_num_threads(2)

H = W = 64
FX = FY = 0.5 * W / np.tan(0.5 * np.deg2rad(60.0))
SH = 1
MODEL = VanillaConfig(sh_degree=SH, background_color="white")
RASTER = RasterizeConfig(isect_capacity=1 << 13, backend="plain")


class Ranges:
    """Stands in for ``record_range``: counts the ranges entered."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        Ranges.entered += 1

    def __exit__(self, *exc):
        return None


@pytest.fixture
def ranges(monkeypatch):
    Ranges.entered = 0
    monkeypatch.setattr(profiler, "record_range", Ranges)
    return Ranges


def _scene(seed=0, n=200, capacity=256):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                    rng.uniform(-8, -3, n)], -1).astype(np.float32)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(seed)
    return init_scene(gen, capacity, (pts, rgb), sh_degree=SH,
                      init_opacity=0.5, device="cpu")


def _camera(dx=0.0):
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[0, 3] = dx
    return Camera.create(FX, FY, W / 2, H / 2, c2w, device="cpu")


def _gt(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(H, W, 3, generator=g)


def _train_step(tmp_path):
    state = tstep.init_train_state(_scene())
    fn = tstep.make_train_step(MODEL, RASTER, OptimizerConfig(), H, W, SH)
    return lambda: fn(state, _camera(), _gt())


def _micro_step(tmp_path):
    state = tstep.init_train_state(_scene())
    fn = tstep.make_train_step(MODEL, RASTER, OptimizerConfig(), H, W, SH,
                               micro_batch=2)
    cams = [_camera(0.0), _camera(0.2)]
    stacked = Camera(**{k: torch.stack([getattr(c, k) for c in cams])
                        for k in ("fx", "fy", "cx", "cy", "c2w")})
    return lambda: fn(state, stacked, torch.stack([_gt(1), _gt(2)]))


def _refine(tmp_path):
    trainer = Trainer(TrainerConfig(model=MODEL), device="cpu")
    state = tstep.init_train_state(_scene())
    tstep.make_train_step(MODEL, RASTER, OptimizerConfig(), H, W, SH)(
        state, _camera(), _gt())
    trainer.state = state
    trainer.datamanager = types.SimpleNamespace(num_train_global=4,
                                                image_size=(H, W))
    trainer.generator = torch.Generator().manual_seed(3)
    return trainer._refine


def _render(tmp_path):
    save_scene(tmp_path, _scene(), step=7, extras={"sh_degree": SH})
    r = Renderer(tmp_path, model_config=MODEL, device="cpu",
                 raster_config=RasterizeConfig(isect_capacity=1 << 13,
                                               backend="plain",
                                               forward_only=True))
    c2w = np.eye(4, dtype=np.float32)[:3]
    return lambda: r.get_output_from_pose(c2w, FX, FY, W / 2, H / 2, H, W)


def _nested(prof):
    """The ``gstk.*`` ranges of a trace in order of start, each name
    prefixed by a dot for every range that holds it."""
    evs = sorted((e.time_range.start, -e.time_range.end, e.name[len(profiler.PREFIX):])
                 for e in prof.events() if e.name.startswith(profiler.PREFIX))
    out, open_ends = [], []
    for start, neg_end, name in evs:
        while open_ends and open_ends[-1] <= start:
            open_ends.pop()
        out.append("." * len(open_ends) + name)
        open_ends.append(-neg_end)
    return out


LAYERS = [".project", ".raster", ".loss", ".backward"]
CASES = {
    "train_step": (_train_step, ["step", *LAYERS, ".update"]),
    "micro_train_step": (_micro_step, ["step", *LAYERS, *LAYERS, ".update"]),
    "refine": (_refine, ["refine"]),
    "get_output_from_pose": (_render, ["project", "raster", "copy_out"]),
}


@pytest.mark.parametrize("recording", [False, True])
def test_a_span_counts_and_enters_a_range_only_while_recording(ranges, recording):
    before = profiler.PROFILER.counts["section"]
    if recording:
        with profile(activities=[ProfilerActivity.CPU]):
            with profiler.timer("section"):
                pass
    else:
        with profiler.timer("section"):
            pass
    assert profiler.PROFILER.counts["section"] == before + 1
    assert ranges.entered == int(recording)


@pytest.mark.parametrize("entry", list(CASES))
def test_entry_point_spans(entry, tmp_path, monkeypatch):
    make, want = CASES[entry]
    call = make(tmp_path)
    # off: the host-clock means count each span, and no range is entered
    counts = dict(profiler.PROFILER.counts)
    with monkeypatch.context() as m:
        Ranges.entered = 0
        m.setattr(profiler, "record_range", Ranges)
        call()
        assert Ranges.entered == 0
    opened = collections.Counter(n.lstrip(".") for n in want)
    assert {k: profiler.PROFILER.counts[k] - counts.get(k, 0)
            for k in opened} == dict(opened)
    # on: the ranges land in the trace, nested as the layers are
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    assert _nested(prof) == want
