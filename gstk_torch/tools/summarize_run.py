"""Summarize a training run's metrics.jsonl into a markdown report (port of
``tools/summarize_run.py``): PSNR/loss curves (sampled table), step-time
drift vs Gaussian count, eval-set metrics, refinement growth — the evidence
tables for full-schedule runs (reference operating point
method_configs.py:41). gs-train writes the same keys in both packages.

Usage: python -m gstk_torch.tools.summarize_run runs/<exp>/<method> \\
           [--out report.md] [--every 1000]
"""

import argparse
import json
import statistics
from pathlib import Path


def report(run_dir: Path, every: int = 1000) -> str:
    """The markdown report of ``run_dir``'s ``metrics.jsonl``."""
    mpath = Path(run_dir) / "metrics.jsonl"
    rows = [json.loads(l) for l in mpath.read_text().splitlines() if l.strip()]
    train = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "eval_psnr" in r]

    def near(step):
        return min(train, key=lambda r: abs(r["step"] - step))

    last = train[-1]["step"]
    lines = []
    lines.append(f"Run: `{run_dir}`  — {last + 1} steps logged\n")
    lines.append("| step | loss | train PSNR | alive | isects | ms/step | rays/s |")
    lines.append("|---|---|---|---|---|---|---|")
    steps = list(range(0, last + 1, every)) + [last]
    seen = set()
    for s in steps:
        r = near(s)
        if r["step"] in seen:
            continue
        seen.add(r["step"])
        lines.append(
            f"| {r['step']} | {r['loss']:.4f} | {r['psnr']:.2f} | "
            f"{int(r['num_alive'])} | {int(r.get('num_intersects', 0))} | "
            f"{r.get('Train Iter (time)', 0) * 1e3:.0f} | "
            f"{r.get('Train Rays / Sec', 0):.3g} |"
        )
    if evals:
        lines.append("\n### Eval (full eval split)\n")
        lines.append("| step | PSNR | SSIM |")
        lines.append("|---|---|---|")
        for r in evals:
            lines.append(
                f"| {r['step']} | {r['eval_psnr']:.2f} | {r['eval_ssim']:.4f} |"
            )
    # windowed medians of step time vs alive count (drift evidence)
    lines.append("\n### Step-time drift (median ms per 1k-step window)\n")
    lines.append("| window | median ms | median alive |")
    lines.append("|---|---|---|")
    for w0 in range(0, last + 1, 1000):
        win = [r for r in train if w0 <= r["step"] < w0 + 1000
               and r["step"] % 10 == 0 and r["step"] > 0]
        if not win:
            continue
        ms = statistics.median(r.get("Train Iter (time)", 0) for r in win) * 1e3
        al = statistics.median(r["num_alive"] for r in win)
        lines.append(f"| {w0}-{w0 + 999} | {ms:.0f} | {int(al)} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser("summarize_run")
    ap.add_argument("run_dir", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--every", type=int, default=1000)
    args = ap.parse_args(argv)
    text = report(args.run_dir, args.every)
    if args.out:
        args.out.write_text(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return text


if __name__ == "__main__":
    main()
