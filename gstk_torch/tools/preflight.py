"""The hardware-parity gate (port of ``tools/preflight.py`` and
``tools/preflight.sh``): no quality run on kernels that no card parity run
has passed since their last edit.

The CPU tests run the kernels' plain twins, so they pass whatever a CUDA
kernel computes; only a run on the card holds each kernel against its
twin. So:

* :func:`kernel_hash` fingerprints every file that can change what the
  card computes on the hot path: the CUDA sources and header
  (``gstk_torch/csrc/*.cu*``), their build (``_build.py``), the kernels'
  wrappers (``ops/raster_cuda.py``, ``ops/segment_kernel.py``,
  ``ops/project_cuda.py``, ``train/adam_cuda.py``), the code around them
  (``ops/binning.py``, ``ops/projection.py``, ``ops/rasterize.py``,
  ``ops/sh.py``, ``models/vanilla.py``, ``train/optim.py``) and the losses
  (``utils/losses.py``);
* a stamp, ``.preflight_stamp_torch.json`` at the repo's root (untracked),
  records the hash when a card parity run last passed: ``chip_smoke.py``
  writes it when every phase has passed, and ``run`` when
  ``tests/test_torch_gpu.py -m gpu`` passes on the card;
* :func:`require_fresh` refuses, with exit code 3 and the reason, to
  train on CUDA while the stamp is missing or stale, unless
  ``GSTK_SKIP_PREFLIGHT=1``: :mod:`gstk_torch.tools.run_quality` and
  :mod:`gstk_torch.tools.quality_workflow` call it before they train. It
  never checks a run on the CPU, which runs no kernel.

Usage:
  python -m gstk_torch.tools.preflight check    # exit 0 fresh, 1 stale (and why)
  python -m gstk_torch.tools.preflight stamp --source <name>
  python -m gstk_torch.tools.preflight run      # the gpu tests on the card, then stamp
  python -m gstk_torch.tools.preflight hash
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parents[2]
STAMP_NAME = ".preflight_stamp_torch.json"
KERNEL_GLOBS = ["gstk_torch/csrc/*.cu*"]
KERNEL_FILES = [
    "gstk_torch/_build.py",
    "gstk_torch/models/vanilla.py",
    "gstk_torch/ops/binning.py",
    "gstk_torch/ops/project_cuda.py",
    "gstk_torch/ops/projection.py",
    "gstk_torch/ops/raster_cuda.py",
    "gstk_torch/ops/rasterize.py",
    "gstk_torch/ops/segment_kernel.py",
    "gstk_torch/ops/sh.py",
    "gstk_torch/train/adam_cuda.py",
    "gstk_torch/train/optim.py",
    "gstk_torch/utils/losses.py",
]
SKIP_ENV = "GSTK_SKIP_PREFLIGHT"
GPU_TESTS = "tests/test_torch_gpu.py"


def kernel_files() -> List[str]:
    """The hashed files, relative to :data:`REPO`, sorted."""
    found = [str(p.relative_to(REPO)) for g in KERNEL_GLOBS
             for p in REPO.glob(g)]
    return sorted(set(found) | set(KERNEL_FILES))


def kernel_hash() -> str:
    h = hashlib.sha256()
    for rel in kernel_files():
        p = REPO / rel
        h.update(rel.encode())
        h.update(b"\0")
        h.update(p.read_bytes() if p.exists() else b"<missing>")
        h.update(b"\0")
    return h.hexdigest()


def stamp_path() -> Path:
    return REPO / STAMP_NAME


def read_stamp() -> Optional[Dict]:
    try:
        return json.loads(stamp_path().read_text())
    except (OSError, ValueError):
        return None


def write_stamp(source: str) -> Dict:
    stamp = {"hash": kernel_hash(), "source": source,
             "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    stamp_path().write_text(json.dumps(stamp, indent=1) + "\n")
    return stamp


def stale_reason() -> Optional[str]:
    """None when the kernel files carry a passing card stamp, else why not."""
    stamp = read_stamp()
    if stamp is None:
        return ("NO STAMP: no card parity run is recorded for the current "
                "kernels")
    if stamp.get("hash") != kernel_hash():
        return (f"STALE: the kernel files changed since the last card parity "
                f"pass ({stamp.get('time')}, source={stamp.get('source')})")
    return None


def check(verbose: bool = True) -> bool:
    """True iff the current kernel files carry a passing card stamp."""
    reason = stale_reason()
    if verbose:
        if reason is None:
            stamp = read_stamp()
            print(f"preflight: fresh (stamped {stamp.get('time')} via "
                  f"{stamp.get('source')})", file=sys.stderr)
        else:
            print(f"preflight: {reason}.\nRun `python -m "
                  f"gstk_torch.tools.preflight run` or `python3 chip_smoke.py` "
                  f"on the card first, or set {SKIP_ENV}=1 to override "
                  f"knowingly.", file=sys.stderr)
    return reason is None


def require_fresh(device, tool: str) -> None:
    """Refuse (exit 3) to train on CUDA with a missing or stale stamp,
    unless ``GSTK_SKIP_PREFLIGHT=1``. ``device`` is the run's ``--device``
    (None is CUDA); a CPU run is never checked."""
    if device is not None and str(device).split(":")[0] != "cuda":
        return
    if os.environ.get(SKIP_ENV, "0") == "1":
        return
    if not check():
        print(f"{tool}: REFUSING to train on kernels without a card parity "
              f"pass (see above).", file=sys.stderr)
        raise SystemExit(3)


def run_gpu_tests() -> int:
    """``tests/test_torch_gpu.py -m gpu`` on the card; stamps and returns 0
    when they ran and passed, none skipped."""
    import torch

    if not torch.cuda.is_available():
        print("preflight run: no CUDA device; the gpu tests would skip",
              file=sys.stderr)
        return 1
    print(f"preflight: kernel hash {kernel_hash()[:16]}...; running "
          f"{GPU_TESTS} -m gpu on {torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory(prefix="preflight_") as tmp:
        xml = Path(tmp) / "gpu.xml"
        rc = subprocess.call(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu", GPU_TESTS,
             "--noconftest", "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=REPO)
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
        counts = {k: int(suite.get(k, 0))
                  for k in ("tests", "errors", "failures", "skipped")}
    print(f"preflight: pytest rc {rc}, {counts}", flush=True)
    if rc != 0 or counts["tests"] == 0 or counts["skipped"] or \
            counts["errors"] or counts["failures"]:
        print("preflight: NOT stamped", file=sys.stderr)
        return 1
    write_stamp("test_torch_gpu")
    print("preflight: OK, stamped")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv[0] if argv else "check"
    if cmd == "hash":
        print(kernel_hash())
        return 0
    if cmd == "stamp":
        source = argv[argv.index("--source") + 1] if "--source" in argv else "manual"
        stamp = write_stamp(source)
        print(f"preflight: stamped {stamp['hash'][:16]}... via {source}")
        return 0
    if cmd == "check":
        return 0 if check() else 1
    if cmd == "run":
        return run_gpu_tests()
    print(f"preflight: unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
