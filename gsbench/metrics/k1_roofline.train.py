"""The K1 kernel's share of its roofline in the traced train stretch
(:mod:`_roofline` beside this file)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gsbench_roofline", Path(__file__).with_name("_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(ctx):
    return _roofline.share(ctx, "k1")
