"""What a run loads: no module whose top-level name (the part before the
first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or
``gstk_tpu``; and the plain reference and the work counts load nothing of
``gstk_torch``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from gsbench.tests.tiny import REPO

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in {blocked!r}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
"""


def _python(code: str, blocked, cwd=REPO) -> subprocess.CompletedProcess:
    full = BLOCKER.format(blocked=set(blocked)) + code
    return subprocess.run([sys.executable, "-c", full], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import json, sys, torch
torch.set_num_threads(2)
from pathlib import Path
from gsbench.tests.tiny import tiny_root
from gsbench import run
res = run.run(['--workload', 'render.gs-1spp-30k', '--seed', '3', '--seconds', '0.5'],
              root=tiny_root(Path({str(tmp_path)!r})), allow_cpu=True)
top = sorted({{m.split('.')[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "top": top}}))
"""
    proc = _python(code, ("jax", "jaxlib", "flax", "gstk_tpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert not set(out["top"]) & {"jax", "jaxlib", "flax", "gstk_tpu"}
    assert "gstk_torch" in out["top"]  # the program under test is loaded


def test_the_check_compares_whole_names(monkeypatch):
    import types

    from gsbench import run

    before = set(run._forbidden_modules())
    monkeypatch.setitem(sys.modules, "gstk_tpux", types.ModuleType("gstk_tpux"))
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", types.ModuleType("jaxfoo.bar"))
    assert set(run._forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    assert set(run._forbidden_modules()) == before | {"flax"}


def test_the_reference_loads_nothing_of_the_program():
    code = """
import sys, torch
import gsbench.reference.splat, gsbench.reference.train, gsbench.reference.precision
import gsbench.work, gsbench.work.k1, gsbench.work.k2, gsbench.work.step, gsbench.work.render
import gsbench.scene
print(sorted({m.split('.')[0] for m in sys.modules}))
"""
    proc = _python(code, ("gstk_torch", "jax", "jaxlib", "flax", "gstk_tpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "gstk_torch" not in proc.stdout


def test_no_source_of_the_yardstick_names_the_program():
    """The reference, the work counts and the scene import neither the
    program nor the JAX package, by their sources."""
    files = (list((REPO / "gsbench" / "reference").glob("*.py"))
             + list((REPO / "gsbench" / "work").glob("*.py"))
             + [REPO / "gsbench" / "scene.py"])
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in {"gstk_torch", "gstk_tpu", "jax", "jaxlib"}, (path, n)
