"""Device time of the update a train step: the events launched inside the
program's ``gstk.update`` spans (the densify statistics and Adam)
(:mod:`_layer` beside this file)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gsbench_layer", Path(__file__).with_name("_layer.py"))
_layer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_layer)


def read(ctx):
    return _layer.device_ms(ctx, "update")
