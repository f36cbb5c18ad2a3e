"""Event-bus metrics writer: buffered puts, pluggable backends (a copy of
``gstk_tpu/utils/writer.py``).

Port of the reference observability layer
(``gs_toolkit/utils/writer.py:35-470``): components call
``put_scalar/put_dict/put_image/put_time`` against a global buffered store;
``write_out_storage`` flushes to the enabled backends. Backends here:
rich-terminal LocalWriter with ETA, TensorBoard (via torch.utils.tensorboard,
gated), and JSONL (machine-readable training log). Wandb/Comet hooks can be
registered the same way when those packages exist.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


class EventName:
    """Standard event names (reference utils/writer.py:35-46)."""

    ITER_TRAIN_TIME = "Train Iter (time)"
    TOTAL_TRAIN_TIME = "Train Total (time)"
    TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
    TEST_RAYS_PER_SEC = "Test Rays / Sec"
    CURR_TEST_PSNR = "Eval PSNR"
    ETA = "ETA (time)"
    GAUSSIAN_COUNT = "Gaussian Count"


class Writer:
    def __init__(self):
        self._scalars: List = []
        self._images: List = []
        self.backends: List = []

    def put_scalar(self, name: str, value, step: int) -> None:
        self._scalars.append((name, float(value), int(step)))

    def put_dict(self, d: Dict, step: int, prefix: str = "") -> None:
        for k, v in d.items():
            try:
                self.put_scalar(f"{prefix}{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def put_image(self, name: str, image: np.ndarray, step: int) -> None:
        self._images.append((name, np.asarray(image), int(step)))

    def write_out_storage(self) -> None:
        for backend in self.backends:
            for name, value, step in self._scalars:
                backend.write_scalar(name, value, step)
            for name, image, step in self._images:
                backend.write_image(name, image, step)
            backend.flush()
        self._scalars.clear()
        self._images.clear()


class LocalWriter:
    """Terminal writer with running ETA (reference utils/writer.py:447+)."""

    def __init__(self, max_iter: int, log_every: int = 10):
        self.max_iter = max_iter
        self.log_every = log_every
        self._t0 = time.time()
        self._latest: Dict[str, float] = {}
        self._last_step = -1

    def write_scalar(self, name: str, value: float, step: int) -> None:
        self._latest[name] = value
        self._last_step = max(self._last_step, step)

    def write_image(self, name, image, step):
        pass

    def flush(self) -> None:
        step = self._last_step
        if step < 0 or step % self.log_every != 0:
            return
        elapsed = time.time() - self._t0
        frac = max(step, 1) / max(self.max_iter, 1)
        eta = elapsed / frac * (1 - frac)
        parts = [f"step {step}/{self.max_iter}", f"eta {eta / 60:.1f}m"]
        for k in ("loss", "psnr", "num_alive", EventName.TRAIN_RAYS_PER_SEC):
            if k in self._latest:
                v = self._latest[k]
                parts.append(f"{k}={v:.4g}")
        print("  ".join(parts), flush=True)


class JsonlWriter:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self._row: Dict = {}
        self._step: Optional[int] = None

    def write_scalar(self, name, value, step):
        if self._step is not None and step != self._step and self._row:
            self._emit()
        self._step = step
        self._row[name] = value

    def write_image(self, name, image, step):
        pass

    def _emit(self):
        self._f.write(json.dumps({"step": self._step, **self._row}) + "\n")
        self._row = {}

    def flush(self):
        if self._row:
            self._emit()
        self._f.flush()


class TensorBoardWriter:
    def __init__(self, log_dir):
        from torch.utils.tensorboard import SummaryWriter

        self.tb = SummaryWriter(log_dir=str(log_dir))

    def write_scalar(self, name, value, step):
        self.tb.add_scalar(name, value, step)

    def write_image(self, name, image, step):
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self.tb.add_image(name, img, step, dataformats="HWC")

    def flush(self):
        self.tb.flush()


class WandbWriter:
    """Weights & Biases backend (reference utils/writer.py:327); requires the
    wandb package + credentials."""

    def __init__(self, project: str, name: str, config: Optional[Dict] = None):
        import wandb

        self.run = wandb.init(project=project, name=name, config=config or {})
        self._wandb = wandb

    def write_scalar(self, name, value, step):
        self.run.log({name: value}, step=step)

    def write_image(self, name, image, step):
        self.run.log({name: self._wandb.Image(np.asarray(image))}, step=step)

    def flush(self):
        pass


class CometWriter:
    """Comet ML backend (reference utils/writer.py:387); requires comet_ml."""

    def __init__(self, project: str, name: str):
        import comet_ml

        self.exp = comet_ml.Experiment(project_name=project)
        self.exp.set_name(name)

    def write_scalar(self, name, value, step):
        self.exp.log_metric(name, value, step=step)

    def write_image(self, name, image, step):
        self.exp.log_image(np.asarray(image), name=name, step=step)

    def flush(self):
        pass


GLOBAL_WRITER = Writer()
