"""gs-eval's scores on the CPU do not depend on the thread count
(``gstk_torch.utils.losses.ordered_mean``, ``gstk_torch.settle_cpu_math``).

Tolerance: gs-eval of one checkpoint under 8 threads and under 1, in
this process and in fresh processes, equal bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gstk_torch.utils.losses import ordered_mean

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def test_ordered_mean_ignores_the_thread_count():
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, 200 * 160 * 3).astype(np.float32))
    means = []
    for n in (1, 2, 3, 8):
        torch.set_num_threads(n)
        means.append(ordered_mean(x))
    torch.set_num_threads(2)
    assert all(torch.equal(m, means[0]) for m in means)
    assert means[0].dtype == torch.float32
    assert float(means[0]) == float(np.float32(x.numpy().astype(np.float64).mean()))


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """A run of the port's synthetic set at 160x120 (57,600 values a view,
    past the size at which a CPU mean splits over threads)."""
    from gstk_torch.data.synthetic import generate_synthetic_dataset
    from gstk_torch.scripts.train import main as train_main

    root = tmp_path_factory.mktemp("eval_threads")
    data = generate_synthetic_dataset(root / "ds", n_points=2000, n_views=6,
                                      img_wh=(160, 120), device="cpu")
    train_main(["--device", "cpu", "gaussian-splatting", "--data", str(data),
                "--output-dir", str(root / "out"), "--max-num-iterations",
                "6", "--steps-per-eval-all-images", "0",
                "--steps-per-eval-image", "0", "--isect-capacity", "65536",
                "--model.sh-degree", "1", "--dataparser.eval-mode",
                "interval", "--dataparser.eval-interval", "3",
                "--dataparser.downscale-factor", "1"])
    return root / "out" / "ds" / "gaussian-splatting" / "config.yml"


def test_gs_eval_ignores_the_thread_count(eval_run, tmp_path):
    """gs-eval of one checkpoint under ``torch.set_num_threads(8)`` and
    under 1 in this process, and in fresh processes with 8 threads (where
    the first vector-math call of a process used to differ) and 1: every
    per-view PSNR and SSIM bit for bit."""
    from gstk_torch.scripts import eval as eval_cli

    def scores(res):
        return (res["results"]["psnr"], res["results"]["ssim"],
                res["per_image"]["psnr"], res["per_image"]["ssim"])

    got = []
    for n in (8, 1):
        torch.set_num_threads(n)
        got.append(scores(eval_cli.main([
            "--load-config", str(eval_run), "--output-path",
            str(tmp_path / f"in_{n}.json"), "--skip-lpips", "--device",
            "cpu"])))
    torch.set_num_threads(2)
    for k, n in enumerate((8, 8, 8, 1)):
        out = tmp_path / f"proc_{k}.json"
        subprocess.run([sys.executable, "-m", "gstk_torch.scripts.eval",
                        "--load-config", str(eval_run), "--output-path",
                        str(out), "--skip-lpips", "--device", "cpu"],
                       check=True, capture_output=True,
                       env={**os.environ, "PYTHONPATH": str(REPO),
                            "OMP_NUM_THREADS": str(n)})
        got.append(scores(json.loads(out.read_text())))
    assert len(got[0][2]) == 2
    assert all(g == got[0] for g in got), got
