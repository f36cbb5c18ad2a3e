"""gs-train for gstk_torch: train a Gaussian Splatting method (port of
``gstk_tpu/scripts/train.py``).

    python -m gstk_torch.scripts.train [--device cpu] <method> --data <dir> [--nested.flags ...]

The flags are gstk_tpu's. ``--device``, given before the method, picks the
torch device; without it the run is on ``cuda`` and raises when there is no
card. Multi-device runs start one process per device, under ``torchrun
--nproc-per-node N -m gstk_torch.scripts.train ...`` or with
``--coordinator-address host:port --num-processes N --process-id i`` on
each; rank 0 writes the config, checkpoints and metrics. The resolved config is saved next to the outputs (``config.yml``),
then the trainer runs and the final eval is printed.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from gstk_torch.configs.cli import parse_cli
from gstk_torch.configs.methods import experimental_methods, method_configs
from gstk_torch.configs.serialize import save_config
from gstk_torch.train.trainer import Trainer


def _split_device(argv: List[str]) -> Tuple[Optional[str], List[str]]:
    """``--device X`` / ``--device=X`` before the method, and the rest."""
    if argv and argv[0].startswith("--device="):
        return argv[0].split("=", 1)[1], argv[1:]
    if argv and argv[0] == "--device":
        if len(argv) < 2:
            raise SystemExit("--device needs a value, e.g. --device cpu")
        return argv[1], argv[2:]
    return None, argv


def main(argv=None) -> Trainer:
    """Train; returns the trainer, for callers that run it in process."""
    device, argv = _split_device(list(sys.argv[1:] if argv is None else argv))
    if argv and argv[0] in experimental_methods:
        raise SystemExit(
            f"method '{argv[0]}' is a reserved slot: the reference ships "
            "pipelines/sugar_pipeline.py as an empty placeholder with no "
            "implementation; use surface-gs for surface-aligned refinement."
        )
    method, config = parse_cli(
        "Train a Gaussian Splatting model with gstk_torch", method_configs(),
        argv,
    )
    if str(config.dataparser.data) == ".":
        config.dataparser = dataclasses.replace(
            config.dataparser, data=config.data
        )
    if config.experiment_name == "experiment":
        config.experiment_name = Path(config.data).name or "experiment"

    trainer = Trainer(config, device=device)
    trainer.setup()
    if not trainer.rank:
        save_config(config.run_dir / "config.yml", config)
    trainer.train()
    results = trainer.eval_all(step=config.max_num_iterations)
    if results and not trainer.rank:
        print(f"Final eval: {results}")
    return trainer


if __name__ == "__main__":
    main()
