"""Idle time of the device a train step in the gaps that began while the host
was in the program's ``gstk.depth_terms`` span: the planar fit's ``eigh``
waits for the device there, so the gap after it begins here (:mod:`_layer`
beside this file). None where the program opens no such span."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gsbench_layer", Path(__file__).with_name("_layer.py"))
_layer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_layer)


def read(ctx):
    return _layer.idle_ms(ctx, "depth_terms")
