"""Build the port's CUDA kernels into one shared library, on first use.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together; :data:`SOURCE_FLAGS` adds a source's own),
linked into ``libgstk_torch.so`` with a plain C interface and loaded with
``ctypes``: no PyTorch headers are compiled, so a cold build takes seconds. The library goes to ``build/gstk_torch/<hash>/``
beside the package, keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. The ``-Xptxas -v`` report of
each kernel (registers, shared memory, spills) is kept beside it.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "gstk_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# the projection kernels repeat PyTorch's elementwise ops one rounding at a
# time (csrc/project_common.cuh), so no multiply and add is fused into an fma
SOURCE_FLAGS = {"project_fwd.cu": ["-fmad=false"],
                "project_bwd.cu": ["-fmad=false"]}
LIB_NAME = "libgstk_torch.so"
# the first load builds; a render thread (the viewer's) and the trainer may
# both reach it, and the build's scratch directory is one per process
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()  # the wrappers' launch counters


@dataclasses.dataclass(frozen=True)
class BuildResult:
    library: Path
    ptxas_log: str  # the -Xptxas -v report of every kernel
    seconds: float  # wall time of this call (about 0 when already built)
    built: bool  # False when the library was already there


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one of CUDA_HOME or the default
    toolkit location; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of gstk_torch need the CUDA "
        "toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile and link the library unless this source hash is built."""
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    log = out_dir / "ptxas.log"
    if lib.is_file():
        return BuildResult(lib, log.read_text(), time.perf_counter() - t0, False)

    nvcc = nvcc_path()
    tmp = BUILD_ROOT / f"{out_dir.name}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *CFLAGS, *SOURCE_FLAGS.get(src.name, []),
                   "-Xptxas", "-v", "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        reports, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            reports.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(reports)
            )
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        (tmp / "ptxas.log").write_text("\n".join(reports))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not lib.is_file():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildResult(lib, log.read_text(), time.perf_counter() - t0, True)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().library))
    lib.gstk_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gstk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """One exported launcher with its ctypes signature; it returns the
    ``cudaError_t`` of its launch."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of kernel launches a
    wrapper keeps; the lock keeps the count whole when threads launch
    together (``+=`` on an attribute is a read, an add and a write)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(name: str, err: int) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err != 0:
        msg = library().gstk_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
