"""Device time of the rasterizer a train step: the events launched inside the
program's ``gstk.raster`` spans (footprints, the band loop, tile counts,
binning and sort with K3, record packing, K1, the bands' join)
(:mod:`_layer` beside this file)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gsbench_layer", Path(__file__).with_name("_layer.py"))
_layer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_layer)


def read(ctx):
    return _layer.device_ms(ctx, "raster")
