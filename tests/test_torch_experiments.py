"""The port's KD experiments (`python -m
lmsu_tpu_torch.experiments.<name>`) against the JAX package's
scripts/experiment_*.py on the CPU, with nothing trained: each side's
trainers (or train_distill.main) are replaced by recorders that keep every
arm's configuration and return the same sequence of "best mIoU" values, so
the arms, their configurations field by field, the argv handed to
train_distill (its build_configs on both sides), and the result JSONs
(summarize / _payload and each experiment's output) are compared for the same
argv. Every default output of the port's experiments lies under its output
root and none is a file git tracks; experiments that read results pair with
the port's own. One kd_lift runs end to end at the smallest regime."""

import dataclasses
import importlib
import json
import os
import subprocess
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import scripts.train_distill as jax_train_distill
from lmsu_tpu_torch import train_distill
from lmsu_tpu_torch.common import OUTPUT_ROOT
from lmsu_tpu_torch.experiments import kd_lift

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRAINED = ("kd_lift", "kd_sweep", "kd_cache_equiv", "kd_compression", "kd_crossarch")
RECIPES = ("best_overall", "crossarch_best", "kd_ensemble")
# One argv an experiment, each flag away from its default where it has one; the
# port's runs add --device cpu.
ARGV = {
    "kd_lift": ["--seeds", "0", "1", "--epochs", "3", "--teacher-epochs", "2",
                "--temperature", "3", "--alpha-kl", "0.25", "--num-train", "40",
                "--batch-size", "8", "--scatter-impl", "sorted"],
    "kd_sweep": ["--seed", "0", "--configs", "T1_a.5_b.5", "T2_a0_b.5_feature_only",
                 "--epochs", "2"],
    "kd_cache_equiv": ["--seed", "1", "--epochs", "2", "--num-val", "64"],
    "kd_compression": ["--seed", "0", "--widths", "0.5", "--epochs", "2"],
    "kd_crossarch": ["--seeds", "2", "--teacher-width", "1.5", "--epochs", "2",
                     "--beta-feature", "0.25"],
    "best_overall": ["--seeds", "0", "2"],
    "crossarch_best": ["--seeds", "1"],
    "kd_ensemble": ["--seeds", "0"],
}


def jax_module(name):
    return importlib.import_module(f"scripts.experiment_{name}")


def port_module(name):
    return importlib.import_module(f"lmsu_tpu_torch.experiments.{name}")


class Recorder:
    """Trainer stand-ins for one experiment run: each arm's (kind,
    configuration, keywords), and train() returning 0.51, 0.52, ... in the
    order the arms train."""

    def __init__(self):
        self.arms, self.argvs = [], []
        rec = self

        class Fake:
            kind = None

            def __init__(self, cfg, train_loader, val_loader, **kw):
                rec.arms.append((self.kind, cfg, kw))
                self.state = types.SimpleNamespace(params={}, batch_stats={})
                self.model = torch.nn.Linear(1, 1)
                self.teacher_cache = {"logits": None}

            def train(self, start_epoch=0):
                return rec.value()

        self.Trainer = type("Trainer", (Fake,), {"kind": "ce"})
        self.DistillationTrainer = type("DistillationTrainer", (Fake,), {"kind": "kd"})

    def value(self):
        return round(0.5 + 0.01 * (len(self.arms) + len(self.argvs)), 6)


def fake_train_distill(rec, write_histories):
    """train_distill.main's stand-in: records the argv; on the port's side
    writes each teacher's training_history.json as the CLI would."""
    def main(argv):
        rec.argvs.append(list(argv))
        v = rec.value()
        if write_histories:
            save = argv[argv.index("--save-dir") + 1]
            n = int(argv[argv.index("--num-teachers") + 1]) if "--num-teachers" in argv else 1
            for i in range(n):
                d = Path(save + ("_teacher" if i == 0 else f"_teacher{i}"))
                d.mkdir(parents=True, exist_ok=True)
                (d / "training_history.json").write_text(json.dumps({"val_miou": [v, v - 0.1]}))
        return v
    return main


def run_jax(name, tmp, mp):
    rec = Recorder()
    mod = jax_module(name)
    out = str(tmp / f"jax_{name}.json")
    if name in RECIPES:
        mp.setattr(jax_train_distill, "main", fake_train_distill(rec, write_histories=False))
    else:
        for attr in ("Trainer", "DistillationTrainer"):
            if hasattr(mod, attr):
                mp.setattr(mod, attr, getattr(rec, attr))
        mp.setattr(mod, "build_loaders", lambda cfg: (None, None))
    if name == "kd_compression":  # shapes only: nothing compiles
        real = mod.init_model
        mp.setattr(mod, "init_model", lambda m, key, **kw: jax.eval_shape(
            lambda k: real(m, k, **kw), key))
    result = mod.main(ARGV[name] + ["--output", out])
    return rec, result


def run_port(name, mp):
    rec = Recorder()
    mod = port_module(name)
    if name in RECIPES:
        mp.setattr(train_distill, "main", fake_train_distill(rec, write_histories=True))
    else:
        for attr in ("Trainer", "DistillationTrainer"):
            if hasattr(mod, attr):
                mp.setattr(mod, attr, getattr(rec, attr))
        mp.setattr("lmsu_tpu_torch.experiments.build_loaders", lambda cfg: (None, None))
    result = mod.main(ARGV[name] + ["--device", "cpu"])
    return rec, result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every experiment of both packages once with its ARGV. The port's run in a
    fresh directory in the order their outputs feed each other (kd_lift
    before kd_sweep and kd_compression, kd_crossarch before crossarch_best,
    best_overall before kd_ensemble), from their default paths; the JAX
    scripts' outputs go to a temporary file (their defaults are tracked
    files, which they also read: kd_sweep's and kd_ensemble's baselines)."""
    tmp = tmp_path_factory.mktemp("experiments")
    port_dir = tmp / "port"
    port_dir.mkdir()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ARGV:
            out[name] = {"jax": run_jax(name, tmp, mp)}
        mp.chdir(port_dir)
        for name in ARGV:
            out[name]["port"] = run_port(name, mp)
    out["written"] = sorted(str(p.relative_to(port_dir)) for p in port_dir.rglob("*")
                            if p.is_file())
    return out


def normalized(x, root=None, key=None):
    """A configuration (dataclasses as dicts) made comparable across the
    packages: compute_dtype by name, TrainConfig.log_every (the JAX
    package's alone, read nowhere) dropped, and on the port's side paths
    under the output root taken back to the script's (root stripped, .pth
    for .ckpt)."""
    if dataclasses.is_dataclass(x):
        x = dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: normalized(v, root, k) for k, v in x.items() if k != "log_every"}
    if isinstance(x, (list, tuple)):
        return type(x)(normalized(v, root) for v in x)
    if key == "compute_dtype":
        return str(x).replace("torch.", "") if isinstance(x, torch.dtype) else np.dtype(x).name
    if isinstance(x, str) and root and x.startswith(root + os.sep):
        x = x[len(root) + 1:]
        return x[:-len(".pth")] + ".ckpt" if x.endswith(".pth") else x
    return x


@pytest.mark.parametrize("name", TRAINED)
def test_arms_match_jax_field_by_field(runs, name):
    """The same arms in the same order, each ExperimentConfig (KDConfig
    included) equal to the script's field by field; the teacher handed over
    (JAX variables / the port's state dict) where the script hands one, and
    the same teacher model configuration."""
    jrec, _ = runs[name]["jax"]
    prec, _ = runs[name]["port"]
    assert [a[0] for a in prec.arms] == [a[0] for a in jrec.arms] and jrec.arms
    for (kind, jcfg, jkw), (_, pcfg, pkw) in zip(jrec.arms, prec.arms):
        assert normalized(pcfg, OUTPUT_ROOT) == normalized(jcfg)
        assert pkw.pop("device") == "cpu"
        assert ("teacher_state_dict" in pkw) == ("teacher_variables" in jkw)
        pkw.pop("teacher_state_dict", None)
        jkw.pop("teacher_variables", None)
        assert normalized(pkw) == normalized(jkw)
    if name == "kd_lift":
        kd = prec.arms[2][1].train.kd
        assert (kd.temperature, kd.alpha_kl, kd.use_pallas) == (3.0, 0.25, False)
        assert prec.arms[0][1].train.num_epochs == 2 and prec.arms[1][1].train.num_epochs == 3


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_experiments_hand_train_distill_the_jax_argv(runs, name):
    """The argv each seed hands train_distill is the script's (REGIME, the
    seed, the run directory under the output root, --train-teacher /
    --num-teachers 2) plus --device; train_distill's build_configs of it
    equals the JAX script's build_configs field by field, student and
    teacher."""
    jrec, _ = runs[name]["jax"]
    prec, _ = runs[name]["port"]
    assert len(prec.argvs) == len(jrec.argvs) == len(ARGV[name]) - 1
    for ja, pa in zip(jrec.argvs, prec.argvs):
        i = pa.index("--device")
        assert pa[i:i + 2] == ["--device", "cpu"]
        pa = pa[:i] + pa[i + 2:]
        assert [normalized(a, OUTPUT_ROOT) for a in pa] == ja
        jcfg, jt = jax_train_distill.build_configs(jax_train_distill.make_parser().parse_args(ja))
        pcfg, pt = train_distill.build_configs(train_distill.make_parser().parse_args(pa))
        assert normalized(pcfg, OUTPUT_ROOT) == normalized(jcfg)
        assert normalized(pt) == normalized(jt)


def test_summaries_and_payloads_match_jax(runs):
    """kd_lift's and kd_crossarch's summarize, and the recipe experiments'
    _payload, return the JAX dicts for the same per-seed inputs."""
    rng = np.random.default_rng(0)
    for name, arms in (("kd_lift", ("teacher", "student", "student_kd")),
                       ("kd_crossarch", ("teacher_spatial", "pp_student", "pp_student_kd"))):
        per_seed = {str(s): {a: float(rng.uniform(0.6, 0.95)) for a in arms} for s in (0, 1, 2)}
        argv = ["--teacher-width", "1.5", "--temperature", "4", "--epochs", "7",
                "--num-val", "96"]
        jargs = _jax_args(name, argv)
        pargs = port_module(name).make_parser().parse_args(argv)
        assert port_module(name).summarize(per_seed, pargs) == \
            jax_module(name).summarize(per_seed, jargs)
    per_seed = {str(s): {"teacher": 0.9 + s / 100, "student_best_recipe": 0.93 - s / 50}
                for s in (0, 1, 2)}
    assert port_module("best_overall")._payload(per_seed) == \
        jax_module("best_overall")._payload(per_seed)
    per_seed = {"0": {"teacher_a": 0.9, "teacher_b": 0.91, "teacher_a_reproduces_committed": True,
                      "student_single_teacher_committed": 0.94, "student_ensemble": 0.95,
                      "gap_vs_single": 0.01}}
    assert port_module("kd_ensemble")._payload(per_seed) == \
        jax_module("kd_ensemble")._payload(per_seed)
    args = type("Args", (), {"baseline": str(ROOT / "kd_crossarch_results.json")})
    for seeds in ((0, 1, 2), (1, 7)):
        per_seed = {str(s): {"teacher_spatial_aug": 0.9, "pp_student_best_recipe": 0.92 + s / 100}
                    for s in seeds}
        assert port_module("crossarch_best")._payload(json.loads(json.dumps(per_seed)), args) \
            == jax_module("crossarch_best")._payload(per_seed, args)


class _Parsed(Exception):
    pass


def _jax_args(name, argv):
    """The JAX script's parsed argv: its main's parser, caught at parse."""
    captured = {}
    mod = jax_module(name)
    real = mod.argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured["args"] = real(self, args, namespace)
        raise _Parsed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            mod.main(argv)
    return captured["args"]


def test_results_match_jax(runs):
    """Each experiment's result JSON against the script's for the same recorded
    arms: kd_lift and kd_crossarch whole, kd_cache_equiv but its note and
    wall seconds, kd_sweep and kd_compression but their baselines, which
    are the port's own kd_lift results on its side (the committed TPU
    results on the script's); kd_compression's parameter counts equal the
    JAX package's (the 2x teacher 2,026,052, the student 528,132)."""
    for name in ("kd_lift", "kd_crossarch"):
        assert runs[name]["port"][1] == runs[name]["jax"][1]
    got, want = runs["kd_cache_equiv"]["port"][1], runs["kd_cache_equiv"]["jax"][1]
    drop = lambda d: {k: v for k, v in d.items() if k not in ("note", "train_wall_s")}  # noqa
    assert drop(got) == drop(want) and set(got) == set(want)
    lift = runs["kd_lift"]["port"][1]["per_seed"]["0"]
    got, want = runs["kd_sweep"]["port"][1], runs["kd_sweep"]["jax"][1]
    assert {k: v for k, v in got.items() if k != "baselines"} == \
        {k: v for k, v in want.items() if k != "baselines"}
    assert got["baselines"] == {"student_alone": lift["student"],
                                "student_kd_T2_a.5_b.5": lift["student_kd"],
                                "teacher": lift["teacher"]}
    got, want = runs["kd_compression"]["port"][1], runs["kd_compression"]["jax"][1]
    assert got["sweep"] == want["sweep"] and got["sweep"]["w0.5"]["params"] > 0
    assert (got["teacher"]["params"], got["w1_reference"]["params"]) == (2026052, 528132)
    assert (got["teacher"]["miou"], got["w1_reference"]["student"]) == \
        (lift["teacher"], lift["student"])


def test_recipe_experiments_pair_with_the_ports_runs(runs):
    """kd_ensemble's single-teacher arm is the port's best_overall result,
    crossarch_best's baselines the port's kd_crossarch results."""
    best = runs["best_overall"]["port"][1]["per_seed"]["0"]
    ens = runs["kd_ensemble"]["port"][1]["per_seed"]["0"]
    assert ens["student_single_teacher_committed"] == best["student_best_recipe"]
    cross = runs["crossarch_best"]["port"][1]
    assert cross["config"]["paired_baselines"] == \
        os.path.join(OUTPUT_ROOT, "kd_crossarch_results.json")
    assert "vs_plain" not in cross["per_seed"]["1"]  # kd_crossarch ran seed 2 only


def test_default_outputs_lie_under_the_output_root_and_are_untracked(runs):
    """Every file the port's experiments wrote from their defaults, every run
    directory and every teacher checkpoint they name lies under the output
    root (which .gitignore lists); none is a file git tracks, where the
    scripts' defaults are (e.g. kd_comparison_results.json)."""
    written = runs["written"]
    assert {f"{OUTPUT_ROOT}/{n}" for n in (
        "kd_comparison_results.json", "kd_sweep_results.json", "kd_cache_equiv.json",
        "kd_compression_results.json", "kd_crossarch_results.json",
        "best_overall_results.json", "kd_crossarch_best.json",
        "kd_ensemble_results.json")} <= set(written)
    paths = list(written)
    for name in TRAINED:
        for _, cfg, kw in runs[name]["port"][0].arms:
            paths.append(cfg.train.save_dir)
            paths += [p for p in (cfg.train.kd.teacher_checkpoint,) if p]
    for name in RECIPES:
        for argv in runs[name]["port"][0].argvs:
            paths.append(argv[argv.index("--save-dir") + 1])
    assert all(Path(p).parts[0] == OUTPUT_ROOT for p in paths), paths
    assert f"/{OUTPUT_ROOT}/" in (ROOT / ".gitignore").read_text().split()
    out = subprocess.run(["git", "ls-files"], cwd=ROOT, capture_output=True, text=True)
    if out.returncode == 0:
        tracked = set(out.stdout.split())
        assert "kd_comparison_results.json" in tracked
        assert not set(paths) & tracked


@pytest.mark.parametrize("name", TRAINED + RECIPES)
def test_experiments_raise_without_cuda(name, tmp_path, monkeypatch):
    """Each experiment runs on CUDA unless --device cpu is asked for: it raises
    before it builds anything (the recipe experiments in train_distill)."""
    def no_config(args):
        raise AssertionError("reached build_configs")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(train_distill, "build_configs", no_config)
    monkeypatch.chdir(tmp_path)
    if name == "kd_ensemble":  # it reads best_overall's results first
        (tmp_path / OUTPUT_ROOT).mkdir()
        (tmp_path / OUTPUT_ROOT / "best_overall_results.json").write_text(
            (ROOT / "best_overall_results.json").read_text())
    with pytest.raises(RuntimeError, match="CUDA"):
        port_module(name).main([])
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] in (
        [], ["best_overall_results.json"])


def test_kd_lift_end_to_end_on_the_cpu(tmp_path, capsys):
    """kd_lift whole at the smallest regime its flags allow (one seed, one
    epoch of 2 samples, full width): three arms, the teacher's weights into
    the KD arm, the results in the script's schema under the output root."""
    root = tmp_path / "runs"
    res = kd_lift.main(["--device", "cpu", "--seeds", "0", "--epochs", "1",
                        "--num-train", "2", "--num-val", "2", "--batch-size", "2",
                        "--num-workers", "0", "--output-root", str(root)])
    assert json.loads((root / "kd_comparison_results.json").read_text()) == res
    assert set(res["per_seed"]["0"]) == {"teacher", "student", "student_kd"}
    assert all(0.0 <= v <= 1.0 for v in res["per_seed"]["0"].values())
    assert res["config"] == {"num_train": 2, "num_val": 2, "epochs": 1, "batch_size": 2,
                             "teacher_width": 2.0, "temperature": 2.0, "alpha_kl": 0.5,
                             "beta_feature": 0.5, "seeds": [0]}
    for arm in ("teacher", "student", "student_kd"):
        hist = json.loads((root / "checkpoints" / f"kd_lift_{arm}_s0" /
                           "training_history.json").read_text())
        assert len(hist["val_miou"]) == 1
    kd = torch.load(root / "checkpoints" / "kd_lift_student_kd_s0" / "latest.pth",
                    weights_only=False)
    assert set(kd["proj"]) == {"camera_feat", "lidar_feat", "post_fusion"}
    assert "KD gap: mean" in capsys.readouterr().out
