"""Collate the port's experiment and measurement results into one report.

Counterpart of scripts/summarize_experiments.py: one deterministic,
regenerable report over the result JSONs the port's experiments
(lmsu_tpu_torch/experiments/) and benches write under its output root
(common.OUTPUT_ROOT, torch_runs/; --output-root moves it), each table
citing its source file. Every section reads its JSONs under that root and
prints nothing when they are missing, as the script's do; their text is the
script's. Two parts are the port's own:
  * the header names the card the report was written on, as
    `nvidia-smi --query-gpu=name,power.limit` gives it, and no TPU;
  * the performance section reads only the card's artifacts (SERVING_BENCH,
    FROZEN_BENCH, INPUT_BENCH, DRESS_REHEARSAL and QUANT_ACCURACY below,
    written by bench_serving, bench_frozen_predictor, bench_input_pipeline,
    dress_rehearsal and experiments/quant_accuracy), with the device each
    measurement ran on beside its numbers.

Usage:
  python -m lmsu_tpu_torch.summarize_experiments [--output-root torch_runs] \
      [--output FILE] [--stdout]

Writes <output-root>/RESULTS.md (the script's default, RESULTS.md, is a
file the JAX package keeps in git), or prints with --stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from lmsu_tpu_torch.common import add_output_root_arg

#: The card's artifacts the performance section reads, under the root.
SERVING_BENCH = "docs/serving_bench.json"
FROZEN_BENCH = "docs/frozen_predictor_bench.json"
INPUT_BENCH = "docs/input_pipeline_bench.json"
DRESS_REHEARSAL = "docs/dress_rehearsal.json"
QUANT_ACCURACY = "docs/quant_accuracy.json"


def load(root, path):
    path = os.path.join(root, path)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def pct(x, nd=1):
    return f"{100.0 * x:.{nd}f}"


def f4(x):
    return f"{x:.4f}"


def _f4_or_dash(x):
    return "—" if x is None else f4(x)


def section_kd_lift(out, root):
    d = load(root, "kd_comparison_results.json")
    if not d:
        return
    cfg = d["config"]
    out.append(
        "## Knowledge distillation: 3-way comparison (hard synthetic "
        "benchmark)\n\n"
        f"`kd_comparison_results.json` — scripts/experiment_kd_lift.py; "
        f"{cfg['num_train']} train / {cfg['num_val']} val frames, "
        f"{cfg['epochs']} epochs, B={cfg['batch_size']}, "
        f"{cfg['teacher_width']}x-wide teacher, T={cfg['temperature']}, "
        f"alpha={cfg['alpha_kl']}, beta={cfg['beta_feature']}. Arms share "
        "each seed's data order/init, so the KD effect is the paired "
        "per-seed gap.\n")
    out.append("| seed | teacher | student | student+KD | paired KD gap |")
    out.append("|---|---|---|---|---|")
    gaps = []
    for s, row in sorted(d["per_seed"].items()):
        gap = row["student_kd"] - row["student"]
        gaps.append(gap)
        out.append(f"| {s} | {f4(row['teacher'])} | {f4(row['student'])} | "
                   f"{f4(row['student_kd'])} | **+{pct(gap)} pt** |")
    n = len(gaps)
    out.append(
        f"\nPaired gap positive on **all {n} seeds**: mean "
        f"+{pct(sum(gaps) / n)} pt, min +{pct(min(gaps))} pt. Mean mIoU "
        "teacher "
        f"{f4(sum(r['teacher'] for r in d['per_seed'].values()) / n)} / "
        "student+KD "
        f"{f4(sum(r['student_kd'] for r in d['per_seed'].values()) / n)} / "
        "student "
        f"{f4(sum(r['student'] for r in d['per_seed'].values()) / n)}. "
        "(Seed 3's student collapses to 0.70 — a hard-seed outlier; KD "
        "improves it but does not rescue it, reported as-is.)\n")
    eq = load(root, "kd_cache_equiv.json")
    if eq:
        out.append(
            "Cached-teacher equivalence (`kd_cache_equiv.json`, round-4 "
            f"rerun — the genuine comparison; the r3 artifact's |diff|=0 "
            f"was vacuous, see the script docstring): paired 40-epoch "
            f"seed-{eq['seed']} KD runs from a bit-reproduced teacher — "
            f"in-loop {f4(eq['student_kd_inloop'])} vs cached "
            f"{f4(eq['student_kd_cached'])}, |diff| "
            f"{eq['abs_diff']:.2e} (fp-schedule noise amplified by "
            "training chaos; far inside seed variance) — the benched "
            "headline configuration trains an equivalent model.\n")


def section_kd_sweep(out, root):
    d = load(root, "kd_sweep_results.json")
    if not d:
        return
    out.append("## KD hyperparameter sweep (seed 0)\n")
    out.append("`kd_sweep_results.json` — scripts/experiment_kd_sweep.py. "
               "Baselines: student alone "
               f"{f4(d['baselines']['student_alone'])}, default KD (T=2, "
               f".5/.5) {f4(d['baselines']['student_kd_T2_a.5_b.5'])}, "
               f"teacher {f4(d['baselines']['teacher'])}.\n")
    out.append("| recipe | val mIoU | vs default KD |")
    out.append("|---|---|---|")
    base = d["baselines"]["student_kd_T2_a.5_b.5"]
    for name, v in sorted(d["sweep"].items(), key=lambda kv: -kv[1]):
        dlt = v - base
        out.append(f"| {name} | {f4(v)} | {'+' if dlt >= 0 else ''}"
                   f"{pct(dlt)} pt |")
    reps = []
    for s in (1, 2):
        r = load(root, f"kd_sweep_s{s}.json")
        if r and "T4_a.5_b.5" in r.get("sweep", {}):
            reps.append((s, r["sweep"]["T4_a.5_b.5"],
                         r["baselines"]["student_kd_T2_a.5_b.5"]))
    if reps:
        rep = ", ".join(f"seed {s}: {f4(v)} (T=2: {f4(b)})"
                        for s, v, b in reps)
        out.append(f"\nT=4 replicated on further seeds — {rep}; it beats "
                   "T=2 on every seed tested. Defaults stay at the "
                   "standard T=2 recipe; the sweep documents the "
                   "headroom.\n")
    out.append("Feature matching alone UNDERPERFORMS the plain student "
               "(the MSE term only helps jointly with the KL term); "
               "logit-only KD captures most but not all of the lift.\n")


def section_kd_variants(out, root):
    d = load(root, "kd_variants_results.json")
    if not d:
        return
    out.append("## KD generalizes across the fusion family (seed 0)\n")
    out.append("`kd_variants_results.json` — train_distill.py "
               "--fusion-type, cached teacher.\n")
    out.append("| fusion | teacher | student+KD | student alone | KD gap |")
    out.append("|---|---|---|---|---|")
    for name, r in sorted(d["per_variant"].items()):
        out.append(f"| {name} | {f4(r['teacher'])} | {f4(r['student_kd'])} "
                   f"| {f4(r['student_alone'])} | +{pct(r['kd_gap'])} pt |")
    out.append("\nThe distilled minimal student (494,978 params) is the "
               "best small model overall.\n")


def section_kd_compression(out, root):
    d = load(root, "kd_compression_results.json")
    if not d:
        return
    out.append("## KD under width compression (seed 0)\n")
    out.append(
        "`kd_compression_results.json` — "
        "scripts/experiment_kd_compression.py; same "
        f"{d['teacher']['params']:,}-param teacher "
        f"(mIoU {f4(d['teacher']['miou'])}) distilled into shrinking "
        "students.\n")
    out.append("| student width | params | student alone | student+KD | "
               "KD gap |")
    out.append("|---|---|---|---|---|")
    w1 = d["w1_reference"]
    out.append(f"| 1.0 (reference) | 528,132 | {f4(w1['student'])} | "
               f"{f4(w1['student_kd'])} | "
               f"+{pct(w1['student_kd'] - w1['student'])} pt |")
    for name, r in sorted(d["sweep"].items(), reverse=True):
        out.append(f"| {name[1:]} | {r['params']:,} | {f4(r['student'])} | "
                   f"{f4(r['student_kd'])} | +{pct(r['kd_gap'])} pt |")
    t4 = d.get("t4_extension")
    if t4:
        out.append(
            f"\nSweep-best T=4 recipe compounds with compression: the "
            f"w=0.5 (143,972-param) student reaches "
            f"**{f4(t4['w0.5_T4_student_kd'])}** — a 14x-smaller student "
            "within 0.2 pt of the plain full-width student.\n")
    s1 = load(root, "kd_compression_s1.json")
    if s1 and "w0.5" in s1.get("sweep", {}):
        r = s1["sweep"]["w0.5"]
        out.append(f"w=0.5 replicated on seed 1: +{pct(r['kd_gap'])} pt "
                   f"({f4(r['student'])} -> {f4(r['student_kd'])}).\n")


def section_kd_crossarch(out, root):
    d = load(root, "kd_crossarch_results.json")
    if not d:
        return
    out.append("## Cross-architecture KD: spatial teacher -> PointPillars "
               "student\n")
    out.append("`kd_crossarch_results.json` — "
               "scripts/experiment_kd_crossarch.py; the KD taps are "
               "encoder-agnostic [B,H,W,C] BEV maps, so the teacher and "
               "student may use different LiDAR encoders.\n")
    out.append("| seed | spatial teacher | PP student | PP student+KD | "
               "paired gap |")
    out.append("|---|---|---|---|---|")
    gaps = []
    for s, r in sorted(d["per_seed"].items()):
        gap = r["pp_student_kd"] - r["pp_student"]
        gaps.append(gap)
        out.append(f"| {s} | {f4(r['teacher_spatial'])} | "
                   f"{f4(r['pp_student'])} | {f4(r['pp_student_kd'])} | "
                   f"+{pct(gap)} pt |")
    out.append(f"\nPositive on every seed (mean +{pct(sum(gaps)/len(gaps))} "
               "pt).\n")
    b = load(root, "kd_crossarch_best.json")
    if b and b.get("per_seed"):
        out.append("Best recipe x cross-arch (`kd_crossarch_best.json` — "
                   "scripts/experiment_crossarch_best.py: noisy-student "
                   "KD, T=4, cached clean-input spatial teacher trained "
                   "with photometric augment, PP student):\n")
        out.append("| seed | teacher (aug-trained) | PP student, best "
                   "recipe | vs plain PP | vs in-loop T=2 KD |")
        out.append("|---|---|---|---|---|")
        for s, r in sorted(b["per_seed"].items()):
            vp = r.get("vs_plain")
            vk = r.get("vs_kd_t2")
            out.append(
                f"| {s} | {f4(r['teacher_spatial_aug'])} | "
                f"{f4(r['pp_student_best_recipe'])} | "
                f"{'+' if (vp or 0) >= 0 else ''}{pct(vp) if vp is not None else '—'} pt | "
                f"{'+' if (vk or 0) >= 0 else ''}{pct(vk) if vk is not None else '—'} pt |")
        if "recipe_gap_mean" in b:
            out.append(f"\nPaired gap vs the plain PP student: mean "
                       f"+{pct(b['recipe_gap_mean'])} pt, min "
                       f"{'+' if b['recipe_gap_min'] >= 0 else ''}"
                       f"{pct(b['recipe_gap_min'])} pt.\n")
        else:
            out.append("")


def section_augment(out, root):
    d = load(root, "augment_results.json")
    if not d:
        return
    a = d["config"]["augment"]
    out.append("## Device-side augmentation lift (paired with the KD-lift "
               "arms)\n")
    out.append(
        "`augment_results.json` — scripts/experiment_augment.py; the "
        "standard recipe (hflip "
        f"{a['hflip_prob']}, brightness/contrast {a['brightness']}/"
        f"{a['contrast']}, noise {a['image_noise_std']}, point dropout "
        f"{a['point_dropout']}) jitted into the train step "
        "(ops/augment.py), same regime/seeds as the KD-lift table so "
        "gaps are paired per seed.\n")
    has_noisy = any("student_kd_noisy" in r for r in d["per_seed"].values())
    has_t4 = any("student_kd_noisy_t4" in r for r in d["per_seed"].values())
    hdr = "| seed | teacher | student | +aug | +KD | +KD+aug (in-loop)"
    sep = "|---|---|---|---|---|---|"
    if has_noisy:
        hdr += " | noisy-student KD"
        sep += "---|"
    if has_t4:
        hdr += " | noisy-student T=4"
        sep += "---|"
    out.append(hdr + " |")
    out.append(sep)
    for s, r in sorted(d["per_seed"].items()):
        row = (f"| {s} | {f4(r['teacher'])} | {f4(r['student'])} | "
               f"{f4(r['student_aug'])} | {f4(r['student_kd'])} | "
               f"{f4(r['student_kd_aug'])}")
        if has_noisy:
            n = r.get("student_kd_noisy")
            row += f" | {f4(n)}" if n is not None else " | —"
        if has_t4:
            n = r.get("student_kd_noisy_t4")
            row += f" | **{f4(n)}**" if n is not None else " | —"
        out.append(row + " |")
    out.append(
        f"\nAugmentation alone: mean {'+' if d['aug_gap_mean'] >= 0 else ''}"
        f"{pct(d['aug_gap_mean'])} pt (min "
        f"{'+' if d['aug_gap_min'] >= 0 else ''}{pct(d['aug_gap_min'])}) — "
        "it helps the weak/overfitting seeds most. Naive in-loop KD+aug "
        "is a wash on top of KD (mean "
        f"{'+' if d['aug_on_top_of_kd_mean'] >= 0 else ''}"
        f"{pct(d['aug_on_top_of_kd_mean'])} pt): the teacher never trained "
        "on augmented inputs, so flipping/noising its input degrades its "
        "targets.\n")
    if has_noisy:
        rows = {s: r for s, r in d["per_seed"].items()
                if "student_kd_noisy" in r}
        beats_t = sum(r["student_kd_noisy"] > r["teacher"]
                      for r in rows.values())
        out.append(
            "**Noisy-student KD** (scripts/experiment_augment_noisy.py: "
            "cached CLEAN-input teacher targets + photometric/dropout "
            "student augmentation — the composition the compatibility "
            "rules recommend) is the best student recipe measured: beats "
            "plain KD on every seed (" + ", ".join(
                f"+{pct(r['student_kd_noisy'] - r['student_kd'])}"
                for _, r in sorted(rows.items()))
            + f" pt), mean +{pct(d['noisy_gap_mean'])} pt over the plain "
            f"student, and EXCEEDS ITS OWN TEACHER on {beats_t}/"
            f"{len(rows)} seeds.\n")
    if has_t4:
        rows = {s: r for s, r in d["per_seed"].items()
                if "student_kd_noisy_t4" in r}
        beats_t = sum(r["student_kd_noisy_t4"] > r["teacher"]
                      for r in rows.values())
        mean = sum(r["student_kd_noisy_t4"] for r in rows.values()) \
            / len(rows)
        out.append(
            "Composing the sweep-best temperature into the noisy-student "
            "recipe (**best recipe**, scripts/experiment_best_recipe.py: "
            "cached clean teacher + photometric augment + T=4) gives the "
            f"best student measured: mean {f4(mean)}, above its own "
            f"teacher on {beats_t}/{len(rows)} seeds (vs T=2 noisy: "
            + ", ".join(
                f"{'+' if r['student_kd_noisy_t4'] >= r['student_kd_noisy'] else ''}"
                f"{pct(r['student_kd_noisy_t4'] - r['student_kd_noisy'])}"
                for _, r in sorted(rows.items())) + " pt).\n")
        w_rows = {s: r for s, r in d["per_seed"].items()
                  if any(k.startswith("student_kd_noisy_t4_w")
                         for k in r)}
        if w_rows:
            frags = []
            for s, r in sorted(w_rows.items()):
                for k in sorted(r):
                    if k.startswith("student_kd_noisy_t4_w"):
                        frags.append(f"seed {s} {k.split('_')[-1]}: "
                                     f"{f4(r[k])}")
            out.append(
                "Compressed best recipe (same arm at reduced student "
                "width): " + "; ".join(frags) + ". MIXED — at half width "
                "the augmentation noise is not reliably beneficial: vs "
                "the same-seed clean-teacher baselines "
                "(kd_compression_results.json) the noisy arm LOSES 3.1 pt "
                "to clean T=4 on seed 0 (0.8466 vs 0.8781) and wins "
                "+0.9 pt over clean T=2 on seed 1; seed 2 reaches 0.8867 "
                "(above its own teacher). The clean T=4 recipe stays the "
                "recommendation for capacity-limited students; the "
                "full-width composition above is the recommendation at "
                "reference size.\n")


def section_best_overall(out, root):
    d = load(root, "best_overall_results.json")
    if not d:
        return
    out.append("## Best overall model: minimal/128 student under the "
               "best recipe\n")
    out.append(
        "`best_overall_results.json` — scripts/experiment_best_overall.py; "
        "the best recipe (cached clean-input teacher targets, "
        "photometric/dropout student augmentation, T=4) applied to the "
        "strongest family (minimal fusion, 494,978 params), teacher = 2x "
        "minimal trained WITH photometric augmentation. Not paired with "
        "the kd_variants table (different teacher); the claim is "
        "absolute best-student accuracy.\n")
    out.append("| seed | teacher | student (best recipe) |")
    out.append("|---|---|---|")
    for s, r in sorted(d["per_seed"].items()):
        out.append(f"| {s} | {f4(r['teacher'])} | "
                   f"**{f4(r['student_best_recipe'])}** |")
    out.append(
        f"\nMean student {f4(d['mean_student'])} — the best student "
        "accuracy measured in this project (prior best small model: "
        "0.9270, kd_variants minimal+KD seed 0), within a point of its "
        "own 2x teacher at a quarter of the teacher's parameters.\n")


def section_kd_ensemble(out, root):
    d = load(root, "kd_ensemble_results.json")
    if not d:
        return
    out.append("## Ensemble-teacher KD: 2 teachers vs 1 under the best "
               "recipe\n")
    out.append(
        "`kd_ensemble_results.json` — scripts/experiment_kd_ensemble.py; "
        "the best-overall regime with the teacher replaced by a 2-member "
        "deep ensemble (independently trained 2x minimal members, seeds "
        "offset 1000; member-averaged logits/taps — EnsembleTeacher). "
        "Paired per seed against best_overall_results.json: member A "
        "reproduces the committed teacher run, so the committed student "
        "is the single-teacher arm.\n")
    out.append("| seed | teacher A | teacher B | student (ensemble) | "
               "student (single, committed) | gap |")
    out.append("|---|---|---|---|---|---|")
    for s, r in sorted(d["per_seed"].items()):
        g = r["gap_vs_single"]
        repro = "" if r["teacher_a_reproduces_committed"] else " (!)"
        out.append(
            f"| {s} | {f4(r['teacher_a'])}{repro} | {f4(r['teacher_b'])} | "
            f"**{f4(r['student_ensemble'])}** | "
            f"{f4(r['student_single_teacher_committed'])} | "
            f"{'+' if g >= 0 else ''}{pct(g)} pt |")
    out.append(
        f"\nMean ensemble student {f4(d['mean_student_ensemble'])} vs "
        f"single-teacher {f4(d['mean_student_single'])}.\n")


def section_teacher_scaling(out, root):
    d = load(root, "teacher_scaling_results.json")
    if not d:
        return
    seed = d["config"]["seed"]
    out.append("## Teacher-width scaling under the best recipe\n")
    out.append(
        f"`teacher_scaling_results.json` — "
        "scripts/experiment_teacher_scaling.py; the best-overall regime "
        f"(seed {seed}) with the teacher's width multiplier swept. "
        "w=2.0 is the committed best_overall anchor (same seed/config); "
        "w=1.0 is self-distillation (teacher == student architecture); "
        "w=4.0 is 16x the student's FLOPs — the regime where the teacher "
        "outgrows one chip and tp/sp teacher partitioning applies.\n")
    out.append("| teacher width | teacher | student |")
    out.append("|---|---|---|")
    for w, r in sorted(d["per_width"].items(), key=lambda t: float(t[0])):
        out.append(f"| {w} | {f4(r['teacher'])} | **{f4(r['student'])}** |")
    out.append("")
    extra = [(s, load(root, f"teacher_scaling_s{s}.json")) for s in (1, 2)]
    extra = [(s, e) for s, e in extra if e and "4.0" in e["per_width"]]
    if extra:
        out.append("w=4.0 replicated across seeds (`teacher_scaling_s{1,2}"
                   ".json`; the w=2.0 anchor is each seed's committed "
                   "best_overall arm):\n")
        out.append("| seed | w=4 teacher | w=4 student | w=2 student "
                   "(committed) | gap |")
        out.append("|---|---|---|---|---|")
        rows = [(str(seed), e["per_width"]) for seed, e in extra]
        rows.insert(0, (str(seed), d["per_width"]))
        for s, pw in rows:
            r4, r2 = pw["4.0"], pw.get("2.0")
            if r2 is None:
                continue
            g = r4["student"] - r2["student"]
            out.append(
                f"| {s} | {f4(r4['teacher'])} | **{f4(r4['student'])}** | "
                f"{f4(r2['student'])} | {'+' if g >= 0 else ''}{pct(g)} pt |")
        out.append("")


def section_capacity_gap(out, root):
    d = load(root, "capacity_gap_results.json")
    if not d:
        return
    seed = d["config"]["seed"]
    sw = d["config"]["student"]
    full = load(root, "teacher_scaling_results.json") or {"per_width": {}}
    out.append("## Capacity gap: teacher width vs a HALF-width student\n")
    out.append(
        "`capacity_gap_results.json` — scripts/experiment_capacity_gap.py; "
        f"same regime/recipe/seed ({seed}) as the teacher-width scaling "
        f"sweep but the student is {sw}. The classic capacity-gap "
        "question (Mirzadeh et al.'s teacher-assistant setup): does the "
        "biggest teacher stop helping once the student is far smaller? "
        "Full-size-student rows repeated from "
        "teacher_scaling_results.json for side-by-side reading.\n")
    out.append("| teacher width | teacher | student w=0.5 | "
               "student w=1.0 (tscale) |")
    out.append("|---|---|---|---|")
    for w, r in sorted(d["per_teacher_width"].items(),
                       key=lambda t: float(t[0])):
        fr = full["per_width"].get(w)
        fs = f4(fr["student"]) if fr else "—"
        out.append(f"| {w} | {f4(r['teacher'])} | **{f4(r['student'])}** | "
                   f"{fs} |")
    out.append("")


def section_ta_chain(out, root):
    d = load(root, "ta_chain_results.json")
    if not d or "student" not in d["stages"]:
        return
    grid = load(root, "capacity_gap_results.json") or {"per_teacher_width": {}}
    out.append("## Teacher-assistant chain (w=4 → w=1 TA → w=0.5)\n")
    out.append(
        "`ta_chain_results.json` — scripts/experiment_ta_chain.py; the "
        "classic Mirzadeh et al. fix for the capacity gap, measured "
        "against the direct cells of the grid above (same seed/regime/"
        "recipe). Stage A distills the grid's w=4 teacher into a "
        "full-size TA (also a reproduction of the tscale w=4 row, "
        f"committed {_f4_or_dash(d['tscale_w4_student_committed'])}); stage B "
        "distills the TA into the half-width student.\n")
    out.append("| arm | w=0.5 student |")
    out.append("|---|---|")
    for tw, r in sorted(grid["per_teacher_width"].items(),
                        key=lambda t: float(t[0])):
        out.append(f"| direct w{tw} → 0.5 | {f4(r['student'])} |")
    out.append(f"| chain w4 → 1 → 0.5 | **{f4(d['stages']['student'])}** |")
    out.append(f"\nStage-A TA (w=1, KD-trained from the w=4 teacher): "
               f"{f4(d['stages']['ta'])}.\n")


def section_ema(out, root):
    d = load(root, "ema_results.json")
    if not d:
        return
    decay = d["config"]["ema_decay"]
    out.append("## EMA weights: measured and closed (neutral here)\n")
    out.append(
        f"`ema_results.json` — scripts/experiment_ema.py; "
        f"TrainConfig.ema_decay={decay} in the same paired regime "
        "(validation and best-checkpointing read the EMA shadow).\n")
    out.append("| seed | student | +EMA | gap | +aug | +aug+EMA | gap |")
    out.append("|---|---|---|---|---|---|---|")
    for s, r in sorted(d["per_seed"].items()):
        g1 = r["student_ema"] - r["student"]
        g2 = r["student_aug_ema"] - r["student_aug"]
        out.append(
            f"| {s} | {f4(r['student'])} | {f4(r['student_ema'])} | "
            f"{'+' if g1 >= 0 else ''}{pct(g1)} pt | "
            f"{f4(r['student_aug'])} | {f4(r['student_aug_ema'])} | "
            f"{'+' if g2 >= 0 else ''}{pct(g2)} pt |")
    out.append(
        f"\nAt decay {decay} over ~520 steps EMA is a wash to slightly "
        "negative (-0.7 to +0.2 pt): cosine annealing already averages "
        "the endpoint, and best-epoch checkpointing on a 40-epoch run "
        "captures the same stability EMA would. Stays a tested opt-in "
        "for long/noisy runs; not part of the best recipe.\n")


def section_fusion_ablation(out, root):
    d = load(root, "fusion_ablation_hard_seeded.json")
    if not d:
        return
    out.append("## Fusion ablation (hard benchmark, 3 seeds, paired)\n")
    out.append("`fusion_ablation_hard_seeded.json` — "
               "scripts/train_fusion_ablation.py per seed.\n")
    out.append("| seed | concat | minimal | weighted |")
    out.append("|---|---|---|---|")
    sums = {"concat": 0.0, "minimal": 0.0, "weighted": 0.0}
    n = 0
    for s, r in sorted(d["per_seed"].items()):
        n += 1
        for k in sums:
            sums[k] += r[k]
        out.append(f"| {s} | {f4(r['concat'])} | {f4(r['minimal'])} | "
                   f"{f4(r['weighted'])} |")
    out.append("| **mean** | " + " | ".join(
        f"**{f4(sums[k] / n)}**" for k in ("concat", "minimal", "weighted"))
        + " |")
    out.append("\nWeighted trails BOTH other variants on every seed; "
               "minimal-vs-concat stays within seed noise. (On the easy "
               "synthetic fixture all three saturate at 0.9997+ — "
               "`fusion_ablation_results.json` — with param counts matching "
               "the reference exactly: 573,442 / 494,978 / 528,132.)\n")
    pp = load(root, "pp_ablation_seeded.json")
    if pp:
        out.append("PointPillars vs spatial LiDAR encoder "
                   "(`pp_ablation_seeded.json`, weighted/128 student): "
                   "paired gaps " + ", ".join(
                       f"{'+' if r['paired_gap'] >= 0 else ''}"
                       f"{pct(r['paired_gap'])}"
                       for _, r in sorted(pp["per_seed"].items()))
                   + f" pt; mean {f4(pp['mean_miou']['pointpillars'])} vs "
                   f"{f4(pp['mean_miou']['spatial'])} — the native PFN is "
                   "competitive end-to-end and avoids spatial's seed-2 "
                   "dip.\n")


def section_weighted_gate(out, root):
    d = load(root, "docs/weighted_gate_analysis.json")
    if not d:
        return
    v = d["gate_variants_val_miou"]
    s = d["gate_stats"]
    out.append("## Why weighted fusion trails: gate ablation on a trained "
               "model\n")
    out.append("`docs/weighted_gate_analysis.json` — "
               "scripts/analyze_weighted_gate.py; eval-time variable edits "
               "replace the per-pixel softmax gate exactly.\n")
    out.append("| gate variant | val mIoU |")
    out.append("|---|---|")
    for k in ("trained", "uniform", "camera_only", "lidar_only"):
        out.append(f"| {k} | {f4(v[k]['miou'])} |")
    out.append(
        f"\nThe learned gate contributes +{pct(d['gate_contribution_pt']/100)}"
        " pt over a uniform gate and is a near-binary switch "
        f"({pct(s['decisive_pixel_fraction_gt_0.7'])}% of pixels decisive "
        "> 0.7) whose camera weight tracks BEV occupancy at rho = "
        f"{s['corr_camera_weight_vs_bev_occupancy']:+.2f} — it selects "
        "camera features where LiDAR returns exist and the (zero-valued) "
        "LiDAR branch elsewhere. A convex per-pixel selection can only "
        "interpolate the modalities; minimal's addition superposes them, "
        "which is what the cross-modal distractors demand — the weighted "
        "family is architecturally capped, not under-trained (full "
        "argument: docs/DESIGN.md).\n")
    g = load(root, "fusion_gated_sum_results.json")
    if g and g.get("per_seed"):
        rows = " / ".join(f4(g["per_seed"][s]["gated_sum"])
                          for s in sorted(g["per_seed"]))
        out.append(
            "The suggested fix was built and measured "
            "(`fusion_gated_sum_results.json` — GatedSumFusion, independent "
            "sigmoid gates, same parameter tree): paired per seed it scores "
            f"{rows} — above weighted on 2/3 seeds but a 12-pt low plateau "
            "on seed 1 and below minimal/concat everywhere. The liability "
            "is the learned gate itself, not its normalization; the "
            "parameter-free addition is the right inductive bias here. "
            "Ships as fusion_type=\"gated_sum\" with this closure as its "
            "documentation.\n")


def _ms(x):
    return "—" if x is None else f"{x:.3f}"


def _stall(x):
    return "—" if x is None else f"{x:.0%}"


def section_perf(out, root):
    """The card's measurements: each artifact of the benches and of
    quant_accuracy that exists under the root, with the device it names."""
    sv, fz = load(root, SERVING_BENCH), load(root, FROZEN_BENCH)
    ip, dr = load(root, INPUT_BENCH), load(root, DRESS_REHEARSAL)
    qa = load(root, QUANT_ACCURACY)
    if not any((sv, fz, ip, dr, qa)):
        return
    out.append("## Performance on the card\n")
    out.append("Each table names the device its numbers were measured on "
               "(`nvidia-smi`'s name and power limit, or `cpu`).\n")
    if sv:
        det = sv["detail"]
        out.append(f"Online serving (`{SERVING_BENCH}` — python -m "
                   f"lmsu_tpu_torch.bench_serving; {sv['device']}; B={det['batch_size']} "
                   f"engine, {det['dtype']}, scatter {det['scatter_impl']}, closed-loop):\n")
        out.append("| concurrency | req/s | p50 ms | p95 ms | p99 ms |")
        out.append("|---|---|---|---|---|")
        for lv in det["levels"]:
            lm = lv["latency_ms"]
            out.append(f"| {lv['concurrency']} | {lv['throughput_rps']} | {_ms(lm['p50'])} | "
                       f"{_ms(lm['p95'])} | {_ms(lm['p99'])} |")
        sat, nb = det.get("saturation"), det.get("null_backend")
        if sat:
            out.append(f"\nOpen-loop saturation ({sat['duration_s']} s, {sv['device']}): "
                       f"{sat['throughput_rps']} req/s at occupancy {sat['occupancy']}, "
                       f"{sat['shed']} shed, e2e p50 {_ms(sat['e2e_latency_ms']['p50'])} ms.")
        if nb:
            out.append(f"Null backend at {nb['batch_ms']} ms a batch (the engine's software "
                       f"ceiling on this host): {nb['throughput_rps']} req/s at occupancy "
                       f"{nb['occupancy']}.")
        out.append("")
    if fz:
        out.append(f"Frozen weights against the module path (`{FROZEN_BENCH}` — python -m "
                   f"lmsu_tpu_torch.bench_frozen_predictor; {fz['device']}; {fz['dtype']}; "
                   f"{fz['iters']} chained forwards in one synchronised run, CUDA events):\n")
        out.append("| B | module ms/forward | frozen ms/forward | one forward ms |")
        out.append("|---|---|---|---|")
        for r in fz["rows"]:
            out.append(f"| {r['batch']} | {_ms(r['runtime_ms'])} | {_ms(r['frozen_ms'])} | "
                       f"{_ms(r['one_forward_ms'])} |")
        out.append("")
    if ip:
        out.append(f"Input pipeline, real decode (`{INPUT_BENCH}` — python -m "
                   f"lmsu_tpu_torch.bench_input_pipeline; {ip['device']}; {ip['frames']} "
                   f"frames of {ip['points']} points, B={ip['batch_size']}, "
                   f"{ip['num_workers']} workers):\n")
        out.append("| epoch | wall s | frames/s | input stall |")
        out.append("|---|---|---|---|")
        for r in ip["epochs"]:
            out.append(f"| {r['epoch']} | {r['wall_s']} | {r['frames_per_sec']} | "
                       f"{_stall(r['stall_frac'])} |")
        out.append("")
    if dr:
        out.append(f"Feeding dress rehearsal (`{DRESS_REHEARSAL}` — python -m "
                   f"lmsu_tpu_torch.dress_rehearsal; {dr['device']}; {dr['frames']} frames "
                   f"({dr['frame_source']}), cached-teacher KD, scatter {dr['scatter_impl']}):\n")
        out.append("| feeding mode | epoch | wall s | frames/s | input stall |")
        out.append("|---|---|---|---|---|")
        for mode, rows in dr["modes"].items():
            for r in rows:
                out.append(f"| {mode} | {r['epoch']} | {r['wall_s']} | "
                           f"{r['frames_per_sec']} | {_stall(r['stall_frac'])} |")
        out.append("")
    if qa:
        out.append(
            f"Int8 (w8a8) post-training quantisation accuracy on a trained model "
            f"(`{QUANT_ACCURACY}` — experiments/quant_accuracy; {qa['device']}; "
            f"{qa['model']}, {qa['benchmark']}): float val mIoU {f4(qa['fp32']['miou'])} "
            f"vs int8 {f4(qa['int8']['miou'])} (delta "
            f"{'+' if qa['miou_delta'] >= 0 else ''}{pct(qa['miou_delta'], 2)} pt), pixel "
            f"argmax agreement {pct(qa['argmax_agreement'], 3)}% — calibrated on "
            f"{qa['calib_batches']} train batches.\n")


def card_name():
    """`nvidia-smi`'s name and power limit of the machine's first card, or
    None where nvidia-smi finds none."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def header(card):
    where = (f"the report was written on {card} (`nvidia-smi`)" if card else
             "`nvidia-smi` found no card on the machine that wrote this report; each "
             "measurement below names the device it ran on")
    return [
        "# RESULTS — the PyTorch port's experiment and measurement report",
        "",
        "Generated by `python -m lmsu_tpu_torch.summarize_experiments` from the result "
        "JSONs under the port's output root (regenerate after adding experiments). "
        "Benchmark: the hard synthetic fixture "
        "(`lmsu_tpu_torch/data/synthetic.py`, `difficulty=\"hard\"`) — "
        "PandaSet-like class imbalance, cross-modal distractors, "
        "occlusions, LiDAR dropout. All accuracy numbers are val mIoU; "
        f"{where}.",
        "",
    ]


SECTIONS = (section_kd_lift, section_kd_sweep, section_kd_variants, section_kd_compression,
            section_kd_crossarch, section_augment, section_best_overall, section_kd_ensemble,
            section_teacher_scaling, section_capacity_gap, section_ta_chain, section_ema,
            section_fusion_ablation, section_weighted_gate, section_perf)


def report(root, card=None) -> str:
    out = header(card)
    for section in SECTIONS:
        section(out, root)
    return "\n".join(out).rstrip() + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_output_root_arg(ap)
    ap.add_argument("--output", default=None, help="default <output-root>/RESULTS.md")
    ap.add_argument("--stdout", action="store_true")
    args = ap.parse_args(argv)
    text = report(args.output_root, card_name())
    if args.stdout:
        sys.stdout.write(text)
    else:
        output = args.output or os.path.join(args.output_root, "RESULTS.md")
        os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
        with open(output, "w") as f:
            f.write(text)
        print(f"wrote {output} ({len(text.splitlines())} lines)")
    return text


if __name__ == "__main__":
    main()
