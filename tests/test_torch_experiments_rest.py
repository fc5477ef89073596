"""The rest of the port's experiments (`python -m
lmsu_tpu_torch.experiments.<name>`: augment, augment_noisy, best_recipe,
teacher_scaling, capacity_gap, ta_chain, ema, gated_sum, quant_accuracy)
against the JAX package's scripts/experiment_*.py on the CPU, with nothing
trained, by the recorder pattern of tests/test_torch_experiments.py: each
side's trainers, train_distill.main or train_synthetic.main are replaced by
recorders that keep every arm's configuration (or argv) and return the same
sequence of "best mIoU" values. Both sides run from a fresh directory of
their own, in the order their outputs feed each other, with the same input
files placed where each looks for them (the scripts in the working
directory, the port under its output root): kd_lift's results, teacher
checkpoints, best_overall's results, the seeded fusion ablation. Compared
for one argv each (every flag off its default where it has one): the arms'
configurations field by field, the argv handed to train_distill /
train_synthetic (and their build_config(s) of it), the payloads. Every
default output of the port lies under its root and none is a file git
tracks; each experiment raises without CUDA unless --device cpu; gated_sum runs
end to end at the smallest regime."""

import importlib
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_experiments import ROOT, Recorder, fake_train_distill, normalized

import scripts.train_distill as jax_train_distill
import scripts.train_synthetic as jax_train_synthetic
from lmsu_tpu_torch import train_distill, train_synthetic
from lmsu_tpu_torch.common import OUTPUT_ROOT
from lmsu_tpu_torch.experiments import gated_sum, quant_accuracy

torch.set_num_threads(2)

TRAINED = ("augment", "augment_noisy", "best_recipe", "gated_sum")
RECIPES = ("teacher_scaling", "capacity_gap", "ta_chain")
ARGV = {
    "augment": ["--seeds", "0", "1", "--teacher-width", "1.5", "--epochs", "3",
                "--num-train", "40", "--batch-size", "8", "--scatter-impl", "pallas"],
    "augment_noisy": ["--seeds", "0", "1", "--teacher-width", "1.5", "--epochs", "3",
                      "--num-train", "40", "--batch-size", "8"],
    "best_recipe": ["--seeds", "1", "--teacher-width", "1.5", "--temperature", "3",
                    "--width", "0.5", "--epochs", "3", "--num-train", "40", "--batch-size", "8"],
    "teacher_scaling": ["--widths", "1.5", "3", "--seed", "1"],
    "capacity_gap": ["--teacher-widths", "1", "4", "--student-width", "0.25", "--seed", "1"],
    "ta_chain": ["--seed", "1"],
    "ema": ["--seeds", "0", "1", "--ema-decay", "0.95"],
    "gated_sum": ["--seeds", "2", "--epochs", "3", "--scatter-impl", "sorted"],
}
NAMES = tuple(ARGV) + ("quant_accuracy",)
# kd_lift's results in the regime augment's ARGV sets (seed 0 only: seed 1's
# baselines are retrained), the seeded fusion ablation, best_overall's
# results: the same numbers for both sides.
KD_LIFT = {"benchmark": "synthetic_hard",
           "config": {"num_train": 40, "num_val": 512, "epochs": 3, "batch_size": 8},
           "per_seed": {"0": {"teacher": 0.91, "student": 0.87, "student_kd": 0.9}}}
ABLATION = {"per_seed": {"2": {"concat": 0.93, "minimal": 0.94, "weighted": 0.9}}}
BEST_OVERALL = {"per_seed": {"1": {"teacher": 0.95, "student_best_recipe": 0.94}}}
TSCALE_TEACHER = {"val_miou": [0.9, 0.92]}


def jax_module(name):
    return importlib.import_module(f"scripts.experiment_{name}")


def port_module(name):
    return importlib.import_module(f"lmsu_tpu_torch.experiments.{name}")


def place_inputs(base: Path, port: bool):
    """The input files each side reads, where it reads them: the script in
    its working directory (checkpoints *.ckpt), the port under its root
    (*.pth). Checkpoints are empty: the recorders never load them."""
    root = base / OUTPUT_ROOT if port else base
    ext = ".pth" if port else ".ckpt"
    # capacity_gap's earlier w=1 teacher run: the script's COMMITTED_TEACHERS
    # name seed 0's runs whatever --seed is; the port reads the run of the
    # seed asked for (ARGV's seed 1).
    earlier = f"checkpoints/tscale_w1.0_s{1 if port else 0}_teacher/training_history.json"
    files = {"kd_comparison_results.json": KD_LIFT,
             "fusion_ablation_hard_seeded.json": ABLATION,
             "best_overall_results.json": BEST_OVERALL,
             earlier: TSCALE_TEACHER}
    for name, obj in files.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_text(json.dumps(obj))
    for run in ("augment_teacher_s0", "augment_teacher_s1", "tscale_w1.5_s1_teacher",
                "capgap_tw4.0_s1_teacher"):
        (root / "checkpoints" / run).mkdir(parents=True, exist_ok=True)
        (root / "checkpoints" / run / f"best{ext}").write_bytes(b"")


def fake_cli(rec):
    """train_synthetic.main's stand-in: records the argv."""
    def main(argv):
        rec.argvs.append(list(argv))
        return rec.value()
    return main


def run_experiment(name, mp, port: bool):
    rec = Recorder()
    mod = port_module(name) if port else jax_module(name)
    td, ts = (train_distill, train_synthetic) if port else (jax_train_distill,
                                                            jax_train_synthetic)
    mp.setattr(td, "main", fake_train_distill(rec, write_histories=True))
    mp.setattr(ts, "main", fake_cli(rec))
    for attr in ("Trainer", "DistillationTrainer"):
        if hasattr(mod, attr):
            mp.setattr(mod, attr, getattr(rec, attr))
    if hasattr(mod, "build_loaders"):
        mp.setattr(mod, "build_loaders", lambda cfg: (None, None))
    if port:
        mp.setattr("lmsu_tpu_torch.experiments.build_loaders", lambda cfg: (None, None))
    result = mod.main(ARGV[name] + (["--device", "cpu"] if port else []))
    return rec, result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every experiment of both packages once with its ARGV, each side in a fresh
    directory with the same inputs placed (place_inputs), in ARGV's order."""
    tmp = tmp_path_factory.mktemp("experiments_rest")
    out = {name: {} for name in ARGV}
    for side in ("jax", "port"):
        base = tmp / side
        base.mkdir()
        place_inputs(base, side == "port")
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(base)
            for name in ARGV:
                out[name][side] = run_experiment(name, mp, side == "port")
        out[f"{side}_written"] = sorted(str(p.relative_to(base)) for p in base.rglob("*")
                                        if p.is_file())
    return out


@pytest.mark.parametrize("name", TRAINED)
def test_arms_match_jax_field_by_field(runs, name):
    """The same arms in the same order, each ExperimentConfig (KDConfig and
    AugmentConfig included, teacher checkpoints by path) equal to the
    script's field by field; a teacher handed over where the script hands
    one; the same teacher model configuration."""
    jrec, _ = runs[name]["jax"]
    prec, _ = runs[name]["port"]
    assert [a[0] for a in prec.arms] == [a[0] for a in jrec.arms] and jrec.arms
    for (_, jcfg, jkw), (_, pcfg, pkw) in zip(jrec.arms, prec.arms):
        assert normalized(pcfg, OUTPUT_ROOT) == normalized(jcfg)
        assert pkw.pop("device") == "cpu"
        assert ("teacher_state_dict" in pkw) == ("teacher_variables" in jkw)
        pkw.pop("teacher_state_dict", None)
        jkw.pop("teacher_variables", None)
        assert normalized(pkw) == normalized(jkw)
    if name == "augment":  # seed 0 reuses kd_lift's baselines, seed 1 retrains them
        assert len(prec.arms) == 3 + 5
        assert prec.arms[0][1].model.lidar.scatter_impl == "pallas"
    if name in ("augment_noisy", "best_recipe"):
        kd = prec.arms[0][1].train.kd
        assert kd.teacher_checkpoint == os.path.join(
            OUTPUT_ROOT, "checkpoints", f"augment_teacher_s{ARGV[name][1]}", "best.pth")


@pytest.mark.parametrize("name", RECIPES + ("ema",))
def test_cli_experiments_hand_the_jax_argv(runs, name):
    """The argv each arm hands train_distill (train_synthetic for ema) is the
    script's plus --device cpu, paths under the output root; the CLI's
    build_config(s) of it equals the JAX CLI's field by field."""
    jrec, _ = runs[name]["jax"]
    prec, _ = runs[name]["port"]
    assert len(prec.argvs) == len(jrec.argvs) > 0
    jcli, pcli = ((jax_train_synthetic, train_synthetic) if name == "ema"
                  else (jax_train_distill, train_distill))
    for ja, pa in zip(jrec.argvs, prec.argvs):
        i = pa.index("--device")
        assert pa[i:i + 2] == ["--device", "cpu"]
        pa = pa[:i] + pa[i + 2:]
        assert [normalized(a, OUTPUT_ROOT) for a in pa] == ja
        pargs = pcli.make_parser().parse_args(pa)
        if name == "ema":
            assert normalized(pcli.build_config(pargs), OUTPUT_ROOT) == \
                normalized(jax_synthetic_config(ja))
        else:
            jargs = jcli.make_parser().parse_args(ja)
            jcfg, jt = jcli.build_configs(jargs)
            pcfg, pt = pcli.build_configs(pargs)
            assert normalized(pcfg, OUTPUT_ROOT) == normalized(jcfg)
            assert normalized(pt) == normalized(jt)


def jax_synthetic_config(argv):
    """The ExperimentConfig scripts/train_synthetic.py builds from `argv`,
    caught at its Trainer (a recorder; nothing is loaded or trained)."""
    rec = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_synthetic, "Trainer", rec.Trainer)
        mp.setattr(jax_train_synthetic, "build_loaders", lambda cfg: (None, None))
        jax_train_synthetic.main(argv)
    (_, cfg, _), = rec.arms
    return cfg


def _paths_to_script(x):
    """A payload with the port's paths taken back to the script's."""
    return json.loads(json.dumps(normalized(x, OUTPUT_ROOT)))


def test_payloads_match_jax(runs):
    """Each payload equals the script's for the same recorded arms; where the
    script names a committed TPU file the port names its own result under
    the root (teacher_scaling's anchor source, gated_sum's paired baselines)
    and ta_chain's tscale_w4_student_committed is the port's own
    teacher_scaling w=4 student, absent here (null)."""
    for name in ("augment", "augment_noisy", "best_recipe", "capacity_gap", "ema"):
        assert _paths_to_script(runs[name]["port"][1]) == runs[name]["jax"][1], name
    got, want = runs["teacher_scaling"]["port"][1], runs["teacher_scaling"]["jax"][1]
    assert got["per_width"]["2.0"].pop("source") == \
        os.path.join(OUTPUT_ROOT, "best_overall_results.json")
    assert want["per_width"]["2.0"].pop("source") == "best_overall_results.json (committed)"
    assert got == want
    assert set(got["per_width"]) == {"2.0", "1.5", "3.0"}
    assert got["per_width"]["3.0"]["cache_dtype"] == "bfloat16"
    assert got["per_width"]["1.5"]["teacher_weights"] == "best_ckpt"
    got, want = runs["ta_chain"]["port"][1], runs["ta_chain"]["jax"][1]
    assert got.pop("tscale_w4_student_committed") is None
    want.pop("tscale_w4_student_committed")
    assert got == want
    got, want = runs["gated_sum"]["port"][1], runs["gated_sum"]["jax"][1]
    assert _paths_to_script(got) == want and got["per_seed"]["2"]["vs_weighted"] == \
        round(got["per_seed"]["2"]["gated_sum"] - 0.9, 4)
    cap = runs["capacity_gap"]["port"][1]["per_teacher_width"]
    assert cap["1.0"]["committed_teacher"] == 0.92 and "committed_teacher" not in cap["4.0"]
    aug = runs["augment"]["port"][1]["per_seed"]
    assert aug["0"]["baselines_reused"] and not aug["1"]["baselines_reused"]
    assert (aug["0"]["student"], aug["0"]["student_kd"]) == (0.87, 0.9)


def test_default_outputs_lie_under_the_output_root_and_are_untracked(runs):
    """Every file the port's experiments wrote (besides the placed inputs) lies
    under the output root, as does every run directory they name; none is
    a file git tracks, where the scripts' defaults are."""
    written = set(runs["port_written"])
    assert {f"{OUTPUT_ROOT}/{n}" for n in (
        "augment_results.json", "teacher_scaling_results.json",
        "capacity_gap_results.json", "ta_chain_results.json", "ema_results.json",
        "fusion_gated_sum_results.json")} <= written
    paths = list(written)
    for name in TRAINED:
        paths += [cfg.train.save_dir for _, cfg, _ in runs[name]["port"][0].arms]
    for name in RECIPES + ("ema",):
        paths += [a[a.index("--save-dir") + 1] for a in runs[name]["port"][0].argvs]
    assert all(Path(p).parts[0] == OUTPUT_ROOT for p in paths), paths
    out = subprocess.run(["git", "ls-files"], cwd=ROOT, capture_output=True, text=True)
    if out.returncode == 0:
        tracked = set(out.stdout.split())
        assert "augment_results.json" in tracked
        assert not set(paths) & tracked


def test_quant_accuracy_regime_and_payload(tmp_path):
    """quant_accuracy's training configuration equals the script's field by
    field for the same argv (the run directory under the root), and its
    payload from a checkpoint has the script's keys plus `device`; the int8
    path's mIoU is finite, the argmax agreement a fraction, the output
    under the root."""
    jmod = jax_module("quant_accuracy")
    argv = ["--calib-batches", "1", "--epochs", "3", "--num-train", "4", "--num-val", "4",
            "--batch-size", "2", "--num-workers", "0"]
    from test_torch_experiments import _jax_args
    jargs = _jax_args("quant_accuracy", argv)
    pargs = quant_accuracy.make_parser().parse_args(argv + ["--device", "cpu"])
    pargs.output_root = OUTPUT_ROOT
    assert normalized(quant_accuracy._regime(pargs), OUTPUT_ROOT) == \
        normalized(jmod._regime(jargs))
    from lmsu_tpu_torch.models import create_model
    cfg = quant_accuracy._regime(pargs)
    ck = tmp_path / "model.pth"
    torch.save({"model_state": create_model(cfg.model, seed=3).state_dict()}, ck)
    root = tmp_path / "runs"
    res = quant_accuracy.main(argv + ["--device", "cpu", "--checkpoint", str(ck),
                                      "--output-root", str(root)])
    assert set(res) == {"benchmark", "model", "regime", "seed", "calib_batches",
                        "trained_best_miou", "fp32", "int8", "miou_delta",
                        "argmax_agreement", "device"}
    assert res["device"] == "cpu" and res["calib_batches"] == 1
    assert np.isfinite(res["int8"]["miou"]) and 0.0 <= res["argmax_agreement"] <= 1.0
    assert json.loads((root / "docs" / "quant_accuracy.json").read_text()) == res


@pytest.mark.parametrize("name", NAMES)
def test_experiments_raise_without_cuda(name, tmp_path, monkeypatch):
    """Each experiment runs on CUDA unless --device cpu is asked for: it raises
    before it builds or writes anything."""
    def no_config(args):
        raise AssertionError("reached build_config")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(train_distill, "build_configs", no_config)
    monkeypatch.setattr(train_synthetic, "build_config", no_config)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_module(name).main([])
    assert not [p for p in tmp_path.rglob("*") if p.is_file()]


def test_gated_sum_end_to_end_on_the_cpu(tmp_path, capsys):
    """gated_sum whole at the smallest regime its flags allow (one seed, one
    epoch of 2 samples, full width), paired with a seeded ablation under the
    root: the result in the script's schema, the paired gaps from it."""
    root = tmp_path / "runs"
    root.mkdir()
    (root / "fusion_ablation_hard_seeded.json").write_text(json.dumps(
        {"per_seed": {"0": {"concat": 0.5, "minimal": 0.6, "weighted": 0.4}}}))
    res = gated_sum.main(["--device", "cpu", "--seeds", "0", "--epochs", "1",
                          "--num-train", "2", "--num-val", "2", "--batch-size", "2",
                          "--num-workers", "0", "--output-root", str(root)])
    assert json.loads((root / "fusion_gated_sum_results.json").read_text()) == res
    row = res["per_seed"]["0"]
    assert 0.0 <= row["gated_sum"] <= 1.0
    assert row["vs_weighted"] == round(row["gated_sum"] - 0.4, 4)
    assert res["config"]["paired_baselines"] == str(root / "fusion_ablation_hard_seeded.json")
    hist = json.loads((root / "checkpoints" / "gated_sum_s0" /
                       "training_history.json").read_text())
    assert len(hist["val_miou"]) == 1
    assert "gated_sum" in capsys.readouterr().out
