"""A small run directory trained by gstk_torch on the CPU, shared by the
back-end tests (``test_torch_eval_render.py``, ``test_torch_export.py``):
the port's synthetic dataset (300 points, 6 views at 64x48, RGBA images and
16-bit depth PNGs), then 12 steps of ``gstk_torch.scripts.train`` with two
refinements, as ``tests/test_torch_cli.py`` trains it. gstk_tpu loads the
same directory (its config file is JSON, which PyYAML reads)."""

import contextlib
import sys
from pathlib import Path

import pytest

TRAIN_ARGS = [
    "--max-num-iterations", "12", "--steps-per-save", "12",
    "--steps-per-eval-all-images", "0", "--steps-per-eval-image", "0",
    "--log-every", "4", "--isect-capacity", "8192", "--raster-chunk", "16",
    "--model.sh-degree", "1", "--model.warmup-length", "2",
    "--model.refine-every", "5",
    "--dataparser.eval-mode", "interval", "--dataparser.eval-interval", "3",
]
BLOCKED = ("PIL", "cv2", "yaml")


@contextlib.contextmanager
def blocked(monkeypatch_ctx, names=BLOCKED):
    """Importing any of ``names`` fails inside the block (the card's
    machine has none of Pillow, OpenCV and PyYAML)."""
    with monkeypatch_ctx() as mp:
        for name in names:
            mp.setitem(sys.modules, name, None)
        yield


def train_run(root: Path) -> Path:
    """Train the run under ``root``; returns its ``config.yml``."""
    from gstk_torch.data.synthetic import generate_synthetic_dataset
    from gstk_torch.scripts.train import main

    generate_synthetic_dataset(root / "ds", n_points=300, n_views=6,
                               img_wh=(64, 48), device="cpu")
    with blocked(pytest.MonkeyPatch.context):
        main(["--device", "cpu", "gaussian-splatting", "--data",
              str(root / "ds"), "--output-dir", str(root / "out"),
              *TRAIN_ARGS])
    return root / "out" / "ds" / "gaussian-splatting" / "config.yml"
