"""Device time of the backward a train step: the events launched while the
program's ``gstk.backward`` span was open (the autograd backward, K2, the
gather, K4), from any thread (:mod:`_layer` beside this file)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gsbench_layer", Path(__file__).with_name("_layer.py"))
_layer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_layer)


def read(ctx):
    return _layer.device_ms(ctx, "backward")
