"""Device time of the program's ``gstk.camera`` spans a train step: camera
optimisation (the exp map before ``gstk.project``, the pose penalty in
``gstk.loss``, the camera group's Adam and metrics in ``gstk.update``)
(:mod:`_layer` beside this file). None where the program opens no such
span."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gsbench_layer", Path(__file__).with_name("_layer.py"))
_layer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_layer)


def read(ctx):
    return _layer.device_ms(ctx, "camera")
