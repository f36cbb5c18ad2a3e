"""The port's hardware-parity gate (``gstk_torch/tools/preflight.py``),
with ``tests/test_preflight.py``'s cases on a copy of the tree: the hash
deterministic and sensitive to an edit of any kernel file, the stamp and
``check`` flipping, the refusal of ``run_quality`` and
``quality_workflow`` on CUDA (a device the tests never reach: they stop at
the gate or fail a mocked trainer) and its exit code, never a check on the
CPU, and the ``GSTK_SKIP_PREFLIGHT=1`` override.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gstk_torch.tools import preflight, quality_workflow, run_quality

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_repo(tmp_path, monkeypatch):
    """A copy of the hashed files, the gate pointed at it, no stamp, and
    no override in the environment."""
    fake = tmp_path / "repo"
    for rel in preflight.kernel_files():
        dst = fake / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes((REPO / rel).read_bytes())
    monkeypatch.setattr(preflight, "REPO", fake)
    monkeypatch.delenv(preflight.SKIP_ENV, raising=False)
    return fake


def test_hash_covers_every_kernel_file():
    files = preflight.kernel_files()
    csrc = sorted(str(p.relative_to(REPO))
                  for p in (REPO / "gstk_torch" / "csrc").iterdir())
    assert csrc and set(csrc) <= set(files)
    assert "gstk_torch/csrc/composite_common.cuh" in files
    assert "gstk_torch/csrc/project_common.cuh" in files
    for rel in ("gstk_torch/_build.py", "gstk_torch/ops/raster_cuda.py",
                "gstk_torch/ops/segment_kernel.py", "gstk_torch/ops/binning.py",
                "gstk_torch/ops/projection.py", "gstk_torch/ops/rasterize.py",
                "gstk_torch/utils/losses.py", "gstk_torch/ops/project_cuda.py",
                "gstk_torch/ops/sh.py", "gstk_torch/models/vanilla.py",
                "gstk_torch/csrc/adam_fused.cu", "gstk_torch/train/adam_cuda.py",
                "gstk_torch/train/optim.py"):
        assert rel in files and (REPO / rel).exists()
    assert files == sorted(files)


@pytest.mark.parametrize("edited", ["gstk_torch/csrc/composite_fwd.cu",
                                    "gstk_torch/csrc/composite_common.cuh",
                                    "gstk_torch/utils/losses.py",
                                    "gstk_torch/csrc/project_bwd.cu",
                                    "gstk_torch/ops/project_cuda.py",
                                    "gstk_torch/models/vanilla.py",
                                    "gstk_torch/csrc/adam_fused.cu",
                                    "gstk_torch/train/adam_cuda.py",
                                    "gstk_torch/train/optim.py"])
def test_hash_stable_and_sensitive(fake_repo, monkeypatch, edited):
    monkeypatch.setattr(preflight, "REPO", REPO)
    h1 = preflight.kernel_hash()
    assert h1 == preflight.kernel_hash()
    monkeypatch.setattr(preflight, "REPO", fake_repo)
    assert preflight.kernel_hash() == h1  # same contents, same hash
    f = fake_repo / edited
    f.write_bytes(f.read_bytes() + b"\n// edit\n")
    assert preflight.kernel_hash() != h1


def test_stamp_roundtrip_and_staleness(fake_repo):
    assert not preflight.check(verbose=False)
    assert "NO STAMP" in preflight.stale_reason()
    stamp = preflight.write_stamp("test")
    assert preflight.check(verbose=False)
    saved = json.loads((fake_repo / preflight.STAMP_NAME).read_text())
    assert saved == stamp and saved["source"] == "test"
    f = fake_repo / "gstk_torch" / "csrc" / "segment_sum.cu"
    f.write_bytes(f.read_bytes() + b"\n// edit\n")
    assert not preflight.check(verbose=False)
    assert "STALE" in preflight.stale_reason()
    assert preflight.main(["check"]) == 1
    assert preflight.main(["stamp", "--source", "again"]) == 0
    assert preflight.main(["check"]) == 0


def test_cli_exit_codes(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-m", "gstk_torch.tools.preflight",
                        "hash"], capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0 and len(r.stdout.strip()) == 64
    int(r.stdout.strip(), 16)
    r = subprocess.run([sys.executable, "-m", "gstk_torch.tools.preflight",
                        "check"], capture_output=True, text=True, env=env,
                       cwd=tmp_path)
    assert r.returncode in (0, 1)
    r = subprocess.run([sys.executable, "-m", "gstk_torch.tools.preflight",
                        "nonsense"], capture_output=True, text=True, env=env)
    assert r.returncode == 2


def test_run_needs_the_card_and_stamps_nothing(fake_repo, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert preflight.main(["run"]) == 1
    assert not (fake_repo / preflight.STAMP_NAME).exists()


def _refused(fn, capsys):
    with pytest.raises(SystemExit) as e:
        fn()
    assert e.value.code == 3
    err = capsys.readouterr().err
    assert "REFUSING" in err and "NO STAMP" in err
    return err


def test_run_quality_refuses_a_stale_stamp_on_cuda(fake_repo, tmp_path, capsys):
    trained = []
    for device in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        err = _refused(lambda: run_quality.main(
            [str(tmp_path / "data"), str(tmp_path / "out"), *device],
            train=lambda argv: trained.append(argv) or 0), capsys)
        assert err.count("run_quality: REFUSING") == 1
    assert trained == []


def test_quality_workflow_refuses_before_any_work(fake_repo, tmp_path,
                                                  monkeypatch, capsys):
    def no_work(*a, **k):
        raise AssertionError("the workflow worked on a stale stamp")

    monkeypatch.setattr(quality_workflow, "prepare_data", no_work)
    monkeypatch.setattr(quality_workflow, "_python_m", no_work)
    err = _refused(lambda: quality_workflow.main(
        ["--capture", "1spp", "--n-views", "64", "--work-dir",
         str(tmp_path), "--out-dir", str(tmp_path / "r")]), capsys)
    assert "quality_workflow: REFUSING" in err
    assert not (tmp_path / "r").exists()


def test_never_checks_on_the_cpu(fake_repo, tmp_path):
    trained = []
    assert run_quality.main([str(tmp_path / "data"), str(tmp_path / "out"),
                             "--device", "cpu"],
                            train=lambda argv: trained.append(argv) or 0) == 0
    assert trained and trained[0][:2] == ["--device", "cpu"]
    preflight.require_fresh("cpu", "test")  # no stamp, no refusal


def test_skip_override_and_a_fresh_stamp_let_cuda_train(fake_repo, tmp_path,
                                                        monkeypatch):
    trained = []
    train = lambda argv: trained.append(argv) or 0
    monkeypatch.setenv(preflight.SKIP_ENV, "1")
    assert run_quality.main([str(tmp_path / "d"), str(tmp_path / "o")],
                            train=train) == 0
    monkeypatch.setenv(preflight.SKIP_ENV, "0")
    with pytest.raises(SystemExit):
        run_quality.main([str(tmp_path / "d"), str(tmp_path / "o")], train=train)
    preflight.write_stamp("test")
    assert run_quality.main([str(tmp_path / "d"), str(tmp_path / "o")],
                            train=train) == 0
    assert len(trained) == 2 and "--device" not in trained[0]


def test_stamp_and_trace_dir_are_ignored_by_git():
    from gstk_torch.tools import profile_step

    lines = (REPO / ".gitignore").read_text().split()
    assert preflight.STAMP_NAME in lines
    assert f"{profile_step.DEFAULT_TRACE_DIR.parts[0]}/" in lines
