"""A checkout of the benchmark cut to a size the CPU runs in seconds: the
manifest and every configuration, traffic and limit file copied into a
temporary root, each configuration shrunk (64 x 64 views, 24 of them, a
few thousand Gaussians) with its widths kept, and the render traffic's
pose cycle cut to six."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {"width": 64, "height": 64, "n_views": 24, "capacity": 4096,
        "alive": 3000, "isect_capacity": 16384}
# six poses a cycle (three eval views, three on the orbit), two checked
TINY_TRAFFIC = {"orbit": 3, "checked": 2, "warmup": 1}


def tiny_root(tmp: Path, scene=None, **changes) -> Path:
    """A root holding ``BENCHMARK.json`` and ``gsbench/`` data files, with
    every configuration cut to :data:`TINY` (and ``changes``; ``scene``
    changes the scene's draw)."""
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "gsbench" / sub, root / "gsbench" / sub)
    for path in (root / "gsbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY, **changes)
        cfg["scene"] = dict(cfg["scene"], scale=0.03, **(scene or {}))
        path.write_text(json.dumps(cfg))
    for path in (root / "gsbench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
        path.write_text(json.dumps(traffic))
    return root
