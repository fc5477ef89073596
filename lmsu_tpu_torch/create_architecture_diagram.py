"""Architecture diagram with the model's own parameter counts.

Counterpart of scripts/create_architecture_diagram.py (reference
create_architecture_diagram.py:6-191): the camera / LiDAR / FPN / fusion /
head block diagram, annotated with counts taken from the port's model
(models/factory.py::get_architecture_summary, count_parameters), not typed
in; --html also writes a static page of the same counts.

Usage:
  python -m lmsu_tpu_torch.create_architecture_diagram [--fusion-type concat] \\
      [--output-root torch_runs] [--output diagram.png] [--html page.html]

The figure goes to torch_runs/architecture_diagram.png by default. It needs
matplotlib and raises, naming it, without it; the counts (summary) need
only torch. Nothing runs on a device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

from lmsu_tpu_torch.common import (FUSION_CHANNELS, FUSION_TYPES, add_output_root_arg,
                                   import_pyplot)
from lmsu_tpu_torch.config import ModelConfig
from lmsu_tpu_torch.models import create_model, get_architecture_summary


def summary(fusion_type: str) -> Dict[str, object]:
    """get_architecture_summary of the 2-class model of `fusion_type` at its
    published width."""
    cfg = ModelConfig(num_classes=2, fusion_type=fusion_type,
                      fusion_out_channels=FUSION_CHANNELS[fusion_type])
    return get_architecture_summary(create_model(cfg))


def render(s: Dict[str, object], fusion_type: str, output: str) -> None:
    plt = import_pyplot()
    from matplotlib.patches import FancyArrowPatch, FancyBboxPatch
    out_ch = FUSION_CHANNELS[fusion_type]
    fig, ax = plt.subplots(figsize=(13, 7))
    ax.set_xlim(0, 13)
    ax.set_ylim(0, 7)
    ax.axis("off")

    def box(x, y, w, h, title, lines, color):
        ax.add_patch(FancyBboxPatch((x, y), w, h, boxstyle="round,pad=0.08",
                                    facecolor=color, edgecolor="black", alpha=0.85))
        ax.text(x + w / 2, y + h - 0.35, title, ha="center", fontsize=11, weight="bold")
        for i, line in enumerate(lines):
            ax.text(x + w / 2, y + h - 0.75 - 0.33 * i, line, ha="center", fontsize=9)

    def arrow(x1, y1, x2, y2):
        ax.add_patch(FancyArrowPatch((x1, y1), (x2, y2), arrowstyle="-|>",
                                     mutation_scale=18, color="black"))

    box(0.4, 4.6, 3.0, 1.9, "Camera encoder",
        ["TwinLite (MobileNetV2)", "256x256x3 -> multiscale",
         f"{s['camera_params']} params"], "#aecbfa")
    box(0.4, 0.6, 3.0, 1.9, "LiDAR encoder",
        ["PointNet MLP + scatter-max", "5000x4 -> 64x64x128",
         f"{s['lidar_params']} params"], "#ccff90")
    box(4.2, 4.6, 2.6, 1.9, "FPN-Lite", ["laterals s3-s5", "-> 64x64x128"], "#aecbfa")
    box(7.4, 2.6, 2.6, 1.9, f"Fusion: {fusion_type}",
        [f"-> 64x64x{out_ch}", f"{s['fusion_params']} params (incl. FPN)"], "#fff0b3")
    box(10.4, 2.6, 2.2, 1.9, "Seg head",
        ["DWSep x2 + 1x1", "-> 64x64x2", f"{s['head_params']} params"], "#f8bbd0")
    arrow(3.4, 5.5, 4.2, 5.5)
    arrow(6.8, 5.3, 7.6, 4.5)
    arrow(3.4, 1.5, 7.6, 2.8)
    arrow(10.0, 3.5, 10.4, 3.5)
    ax.text(6.5, 6.7, "Camera+LiDAR BEV segmentation "
            f"({fusion_type} fusion) — total {s['total_params']} params",
            ha="center", fontsize=13, weight="bold")
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    fig.savefig(output, dpi=130, bbox_inches="tight")
    plt.close(fig)


def html_page(s: Dict[str, object], fusion_type: str) -> str:
    rows = "\n".join(f"<tr><td>{k.replace('_', ' ')}</td><td>{v}</td></tr>"
                     for k, v in s.items())
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>Multi-modal BEV segmentation — architecture</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; }}
 table {{ border-collapse: collapse; }}
 td {{ border: 1px solid #ccc; padding: 0.4rem 0.9rem; }}
 h1 {{ font-size: 1.3rem; }}
</style></head><body>
<h1>Camera+LiDAR BEV segmentation ({fusion_type} fusion)</h1>
<p>Camera: TwinLite 5-stage encoder (256&times;256&times;3 &rarr; multiscale)
 + FPN-Lite &rarr; 64&times;64&times;128.<br>
LiDAR: PointNet MLP + BEV scatter-max (5000&times;4 &rarr;
 64&times;64&times;128).<br>
Fusion &rarr; segmentation head &rarr; 64&times;64&times;2 drivable mask.</p>
<table>{rows}</table>
</body></html>"""


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_output_root_arg(p)
    p.add_argument("--fusion-type", default="concat", choices=list(FUSION_TYPES))
    p.add_argument("--output", default=None,
                   help="default <output-root>/architecture_diagram.png")
    p.add_argument("--html", default=None,
                   help="also write a static HTML page of the counts")
    return p


def main(argv=None) -> Dict[str, object]:
    args = make_parser().parse_args(argv)
    import_pyplot()  # fail first when the figure cannot be drawn
    output = args.output or os.path.join(args.output_root, "architecture_diagram.png")
    s = summary(args.fusion_type)
    render(s, args.fusion_type, output)
    print(f"Wrote {output}")
    for k, v in s.items():
        print(f"  {k}: {v}")
    if args.html:
        with open(args.html, "w") as f:
            f.write(html_page(s, args.fusion_type))
        print(f"Wrote {args.html}")
    return s


if __name__ == "__main__":
    main()
