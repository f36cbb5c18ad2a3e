"""The work a step or a request needs, counted from the semantics and the
inputs, whatever implements it: each module here (``<name>.py``, found by
the name a per-layer metric gives) has ``count(p) -> {"flops", "bytes"}``
of one :class:`Pass`.

:func:`analyse` makes the :class:`Pass` of one view with the plain
reference (:mod:`gsbench.reference.splat`), outside the timed window, on
the inputs of a traced step or request: the scene as it stood, the view,
the raster's bands. The counts it holds are the function's, not a
kernel's: intersections are the (Gaussian, tile) pairs of the binning
(never a buffer's capacity), and ``pairs`` are, for every pixel, the
entries of its tile's front-to-back list up to and including the one at
which its transmittance stops (all of them where it never stops): what
any correct compositor has to evaluate, not what a kernel happens to.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from gsbench.reference import splat
from gsbench.reference.precision import Arith, strict_f32


class Pass(NamedTuple):
    lanes: int  # the state's capacity
    alive: int  # alive Gaussians
    drawn: int  # Gaussians with a footprint in the view
    intersections: int  # (Gaussian, tile) pairs over all bands
    binned: int  # distinct Gaussians with at least one tile
    tiles: int  # tiles over all bands
    pixels: int
    pairs: int  # (pixel, entry) pairs needed, up to each pixel's stop
    channels: int  # composited channels (rgb + depth)
    params_per_lane: int  # floats of one Gaussian's parameters


def analyse(params: Dict[str, torch.Tensor], view: splat.View, sh_degree: int,
            bands: int) -> Pass:
    with strict_f32(), torch.no_grad():
        ar = Arith()
        s = splat.project(params, view, sh_degree, ar)
        lists = splat.bin_tiles(s, view, bands)
        _, _, pairs = splat.composite(s, lists, ar)
    per_lane = sum(params[k][0].numel() for k in
                   ("means", "scales", "quats", "features_dc",
                    "features_rest", "opacities"))
    return Pass(
        lanes=int(params["alive"].numel()), alive=int(params["alive"].sum()),
        drawn=int((s.radii > 0).sum()), intersections=int(lists.gid.numel()),
        binned=int(torch.unique(lists.gid).numel()),
        tiles=int(lists.count.numel()), pixels=view.height * view.width,
        pairs=int(pairs), channels=int(s.colors.shape[1]),
        params_per_lane=int(per_lane))
