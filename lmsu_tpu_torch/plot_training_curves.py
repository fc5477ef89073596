"""Training curves across runs: a 2x2 figure (train / val loss, train / val
mIoU, the best val mIoU starred) and each run's summary line.

Counterpart of scripts/plot_training_curves.py (reference
plot_training_curves.py:16-214). It reads each run's training_history.json,
which the port's trainers write in the JAX schema (train_loss, train_miou,
val_loss, val_miou, lr), and prints what the JAX script prints.

Usage:
  python -m lmsu_tpu_torch.plot_training_curves [--runs DIR ...] [--labels L ...] \\
      [--output-root torch_runs] [--output curves.png]

The default runs are the port's fusion ablation's, under --output-root
(torch_runs/checkpoints/fusion_ablation_{concat,minimal,weighted}), and the
figure goes to torch_runs/training_curves.png. It needs matplotlib and
raises, naming it, without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

from lmsu_tpu_torch.common import add_output_root_arg, import_pyplot

PANELS = (("train_loss", "Train loss"), ("val_loss", "Val loss"),
          ("train_miou", "Train mIoU"), ("val_miou", "Val mIoU"))


def load_histories(runs: List[str], labels: List[str]) -> Dict[str, dict]:
    """{label: history} of the runs that have a training_history.json."""
    histories = {}
    for run, label in zip(runs, labels):
        path = os.path.join(run, "training_history.json")
        if not os.path.exists(path):
            print(f"skip {label}: no {path}")
            continue
        with open(path) as f:
            histories[label] = json.load(f)
    return histories


def summary_lines(histories: Dict[str, dict]) -> List[str]:
    """Each run's best val mIoU, its epoch and its final LR."""
    lines = [f"\n{'run':>28s} {'best val mIoU':>14s} {'@epoch':>7s} {'final lr':>10s}"]
    for label, h in histories.items():
        if h["val_miou"]:
            best = max(h["val_miou"])
            ep = h["val_miou"].index(best) + 1
            lines.append(f"{label:>28s} {best:14.4f} {ep:7d} {h['lr'][-1]:10.2e}")
    return lines


def render(histories: Dict[str, dict], output: str) -> None:
    plt = import_pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    for ax, (key, title) in zip(axes.ravel(), PANELS):
        for label, h in histories.items():
            epochs = range(1, len(h[key]) + 1)
            line, = ax.plot(epochs, h[key], marker="o", markersize=3, label=label)
            if key == "val_miou" and h[key]:
                best_e = max(epochs, key=lambda e: h[key][e - 1])  # noqa: B023
                ax.plot(best_e, h[key][best_e - 1], marker="*", markersize=14,
                        color=line.get_color())
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.grid(alpha=0.3)
        ax.legend()
    fig.suptitle("Training curves")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    fig.savefig(output, dpi=120)
    plt.close(fig)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_output_root_arg(p)
    p.add_argument("--runs", nargs="+", default=None,
                   help="run dirs holding training_history.json; default the fusion "
                   "ablation's under <output-root>/checkpoints")
    p.add_argument("--labels", nargs="+", default=None)
    p.add_argument("--output", default=None,
                   help="default <output-root>/training_curves.png")
    return p


def main(argv=None) -> int:
    p = make_parser()
    args = p.parse_args(argv)
    import_pyplot()  # fail first when the figure cannot be drawn
    runs = args.runs or [os.path.join(args.output_root, "checkpoints", f"fusion_ablation_{f}")
                         for f in ("concat", "minimal", "weighted")]
    output = args.output or os.path.join(args.output_root, "training_curves.png")
    labels = args.labels or [os.path.basename(r.rstrip("/")) for r in runs]
    if len(labels) != len(runs):
        p.error(f"--labels has {len(labels)} entries for {len(runs)} runs (zip would "
                f"silently drop runs)")
    histories = load_histories(runs, labels)
    if not histories:
        print("No histories found.")
        return 1
    render(histories, output)
    print(f"Wrote {output}")
    for line in summary_lines(histories):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
