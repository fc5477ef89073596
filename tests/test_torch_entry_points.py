"""The port's entry points (`python -m lmsu_tpu_torch.train_fusion_ablation`,
`.train_synthetic`, `.train_pandaset`, `.evaluate`, `.train_distill`,
`.prepare_dataset`, `.analyze_distribution`) on the CPU, against the JAX
package's scripts of the same names: their configurations, the ablation's
results file in the JAX schema with the JAX package's parameter counts, one
epoch each at a small size (narrow encoders and 64^2 images; the fusion,
its channels and the head as the entry point sets them), the evaluation
reading back what the trainer recorded, packs written from a fabricated
PandaSet tree byte-identical to the JAX script's, and the distribution
audit's output equal to the JAX script's. The trainers raise without a GPU
unless given --device cpu."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import preset_fusion_ablation as jax_preset
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu.models import get_architecture_summary as jax_summary
from lmsu_tpu_torch import (analyze_distribution, evaluate, prepare_dataset, train_distill,
                            train_fusion_ablation, train_pandaset, train_synthetic)
from lmsu_tpu_torch.common import STANDARD_AUGMENT
from lmsu_tpu_torch.config import (AugmentConfig, CameraEncoderConfig, preset_fusion_ablation,
                                   preset_pandaset_weighted, teacher_config)

torch.set_num_threads(2)

IMG, GRID, NPTS = 64, (16, 16), 256
NARROW = dict(camera_fpn_channels=16)
NARROW_LIDAR = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID)
DATA = ["--dataset", "synthetic", "--num-train", "4", "--num-val", "4", "--batch-size", "2",
        "--num-workers", "0"]


def small(cfg):
    """`cfg` with narrow encoders, 64^2 images, a 16^2 grid and 256 points;
    the fusion, its channels and the head as given."""
    model = cfg.model.replace(camera=CameraEncoderConfig(base_channels=8),
                              lidar=dataclasses.replace(cfg.model.lidar, **NARROW_LIDAR),
                              **NARROW)
    data = dataclasses.replace(cfg.data, image_size=(IMG, IMG), grid_size=GRID,
                               max_points=NPTS)
    return cfg.replace(model=model, data=data)


def test_fusion_ablation_configs_match_jax():
    """The preset is the JAX package's (models, class weights, epochs, run
    dirs, PandaSet data); the entry point keeps the preset's dataset unless
    --dataset is given, and sets <prefix>_<type>."""
    for fusion in ("concat", "minimal", "weighted", "gated_sum"):
        j, p = jax_preset(fusion), preset_fusion_ablation(fusion)
        for a, b in ((j.model, p.model), (j.train, p.train)):
            for f in ("fusion_type", "fusion_out_channels", "num_classes", "output_mode",
                      "num_epochs", "class_weights", "save_dir"):
                assert getattr(a, f, None) == getattr(b, f, None), f
        assert j.data.dataset == p.data.dataset == "pandaset"
        for extra, dataset in (([], "pandaset"), (["--dataset", "synthetic"], "synthetic")):
            args = train_fusion_ablation.make_parser().parse_args(["--run-prefix", "runs/ab"]
                                                                  + extra)
            cfg = train_fusion_ablation.variant_config(fusion, args)
            assert (cfg.data.dataset, cfg.train.save_dir) == (dataset, f"runs/ab_{fusion}")
            assert not cfg.train.kd.enabled
    args = train_fusion_ablation.make_parser().parse_args(["--kd"])
    assert train_fusion_ablation.variant_config("concat", args).train.kd.enabled
    assert train_fusion_ablation.VARIANTS == ("concat", "minimal", "weighted")


def test_fusion_ablation_cli_writes_the_jax_schema(tmp_path, monkeypatch):
    """One epoch of each variant, sorted scatter: the results file has the
    JAX script's schema, and its count strings are the JAX package's
    get_architecture_summary for the same configurations."""
    monkeypatch.setattr(train_fusion_ablation, "preset_fusion_ablation",
                        lambda fusion: small(preset_fusion_ablation(fusion)))
    out = tmp_path / "fusion_ablation_results.json"
    res = train_fusion_ablation.main(
        ["--device", "cpu", "--epochs", "1", "--scatter-impl", "sorted_pallas",
         "--run-prefix", str(tmp_path / "ab"), "--output", str(out)] + DATA)
    assert json.loads(out.read_text()) == res
    assert list(res) == ["concat", "minimal", "weighted"]
    for fusion, r in res.items():
        assert set(r) == {"miou", "total_params", "fusion_params"}
        assert 0.0 <= r["miou"] <= 1.0
        j = jax_preset(fusion)
        jcfg = j.model.replace(camera=JCam(base_channels=8),
                               lidar=JLidar(**NARROW_LIDAR), **NARROW)
        jm = jax_create_model(jcfg)
        shapes = jax.eval_shape(lambda k: jm.init(  # noqa: B023
            k, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, NPTS, 4)), train=False),
            jax.random.PRNGKey(0))
        want = jax_summary(jm, shapes)
        assert (r["total_params"], r["fusion_params"]) == \
            (want["total_params"], want["fusion_params"]), fusion
        hist = json.loads((tmp_path / f"ab_{fusion}" / "training_history.json").read_text())
        assert hist["val_miou"] == [r["miou"]]


def test_fusion_ablation_cli_distils_with_kd(tmp_path, monkeypatch):
    """--kd trains each chosen variant with DistillationTrainer from its 2x
    teacher (random here, as without --teacher-checkpoint in the JAX
    script); the results file holds the chosen variants only."""
    monkeypatch.setattr(train_fusion_ablation, "preset_fusion_ablation",
                        lambda fusion: small(preset_fusion_ablation(fusion)))
    out = tmp_path / "kd.json"
    res = train_fusion_ablation.main(
        ["--device", "cpu", "--epochs", "1", "--variants", "concat", "--kd",
         "--run-prefix", str(tmp_path / "kd"), "--output", str(out)] + DATA)
    assert list(res) == ["concat"] and json.loads(out.read_text()) == res
    assert set(torch.load(tmp_path / "kd_concat" / "latest.pth", weights_only=False)["proj"]) \
        == {"camera_feat", "lidar_feat", "post_fusion"}


@pytest.mark.parametrize("ema", [False, True], ids=["plain", "ema"])
def test_train_synthetic_then_evaluate_reads_back_its_val_miou(tmp_path, monkeypatch, ema):
    """train_synthetic builds concat/256 (5 epochs, class weights 0.4 / 3.5,
    as scripts/train_synthetic.py); one epoch of it, then evaluate on its
    latest.pth gives the val loss and mIoU the trainer recorded (the same
    weights, split and eval epoch; with --ema-decay, the EMA's weights, as
    the trainer validated with them)."""
    args = train_synthetic.make_parser().parse_args([])
    cfg = train_synthetic.build_config(args)
    assert (cfg.model.fusion_type, cfg.model.fusion_out_channels, cfg.train.num_epochs,
            cfg.train.class_weights) == ("concat", 256, 5, (0.4, 3.5))
    for module in (train_synthetic, evaluate):
        real = module.build_config
        monkeypatch.setattr(module, "build_config", lambda a, real=real: small(real(a)))
    run = tmp_path / "run"
    flags = ["--device", "cpu", "--scatter-impl", "sorted_pallas"] + DATA
    extra = ["--ema-decay", "0.5"] if ema else []
    best = train_synthetic.main(flags + extra + ["--epochs", "1", "--save-dir", str(run)])
    hist = json.loads((run / "training_history.json").read_text())
    assert hist["val_miou"] == [best] or best == 0.0
    payload = torch.load(run / "latest.pth", weights_only=False)
    assert ("ema" in payload) == ema
    res = evaluate.main(flags + ["--checkpoint", str(run / "latest.pth"),
                                 "--save-dir", str(tmp_path / "eval"),
                                 "--output-json", str(tmp_path / "m.json")])
    assert json.loads((tmp_path / "m.json").read_text()) == res
    assert set(res) == {"checkpoint", "split", "loss", "miou", "class_iou"}
    assert res["split"] == "val" and len(res["class_iou"]) == 2
    assert (res["loss"], res["miou"]) == (pytest.approx(hist["val_loss"][0], rel=1e-6),
                                          hist["val_miou"][0])


@pytest.mark.parametrize("cli, argv", [
    (train_synthetic, []), (train_fusion_ablation, []), (train_pandaset, []),
    (evaluate, ["--checkpoint", "latest.pth"])],
    ids=["train_synthetic", "train_fusion_ablation", "train_pandaset", "evaluate"])
def test_entry_point_raises_without_cuda(monkeypatch, cli, argv):
    """CUDA is the default device; without a GPU the entry point raises
    before it builds anything, unless given --device cpu."""
    assert cli.make_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)


def test_common_flags_are_the_ported_options_only():
    """Flags of options the port refuses are absent (argparse rejects
    --model-parallel); --data-root, --decoded-cache and --dataset set their
    fields, and without --dataset the preset's holds; --fusion-type takes
    the four fusions; the loop and run-control flags and --lidar-encoder set
    their fields."""
    p = train_synthetic.make_parser()
    with pytest.raises(SystemExit):
        p.parse_args(["--model-parallel", "2"])
    with pytest.raises(SystemExit):
        p.parse_args(["--dataset", "nuscenes"])
    data = train_synthetic.build_config(p.parse_args(
        ["--dataset", "packed", "--data-root", "packs/x", "--decoded-cache"])).data
    assert (data.dataset, data.root, data.decoded_cache) == ("packed", "packs/x", True)
    data = train_synthetic.build_config(p.parse_args([])).data
    assert (data.dataset, data.root, data.decoded_cache) == ("synthetic", "data/pandaset", False)
    for dataset in ("pandaset", "synthetic", "packed"):
        assert train_synthetic.build_config(p.parse_args(["--dataset", dataset])).data.dataset \
            == dataset
    cfg = train_synthetic.build_config(p.parse_args(
        ["--scan-steps", "13", "--onchip-epoch", "--onchip-eval", "--progress",
         "--snapshot-every", "2", "--handle-sigterm", "--async-checkpoint",
         "--lidar-encoder", "pointpillars"]))
    tc = cfg.train
    assert (tc.scan_steps, tc.onchip_epoch, tc.onchip_eval, tc.progress, tc.snapshot_every,
            tc.handle_sigterm, tc.async_checkpoint) == (13, True, True, True, 2, True, True)
    assert cfg.model.lidar.encoder_type == "pointpillars"
    tc = train_synthetic.build_config(p.parse_args([])).train
    assert (tc.scan_steps, tc.onchip_epoch, tc.onchip_eval, tc.snapshot_every) == \
        (1, False, None, None)
    # Augmentation is ported: --augment is the standard recipe, an --aug-*
    # flag sets its term (alone, without --augment).
    assert not train_synthetic.build_config(p.parse_args([])).train.augment.enabled
    aug = train_synthetic.build_config(p.parse_args(["--augment"])).train.augment
    assert dataclasses.asdict(aug) == dataclasses.asdict(AugmentConfig(**STANDARD_AUGMENT))
    aug = train_synthetic.build_config(p.parse_args(["--aug-brightness", "0.2"])).train.augment
    assert (aug.enabled, aug.brightness, aug.hflip_prob, aug.point_dropout) == (True, 0.2, 0, 0)
    for fusion in ("concat", "minimal", "weighted", "gated_sum"):
        cfg = train_synthetic.build_config(p.parse_args(["--fusion-type", fusion,
                                                         "--fusion-channels", "64"]))
        assert (cfg.model.fusion_type, cfg.model.fusion_out_channels) == (fusion, 64)
    cfg = train_synthetic.build_config(p.parse_args(["--bf16", "--epochs", "2"]))
    assert cfg.model.compute_dtype == torch.bfloat16 and cfg.train.num_epochs == 2
    assert np.isclose(cfg.train.lr, 1e-3)


# -- the best KD recipe through train_distill ---------------------------------

RECIPE = ["--difficulty", "hard", "--fusion-type", "minimal", "--fusion-channels", "128",
          "--train-teacher", "--cache-teacher", "--cache-hbm-gb", "6", "--temperature", "4",
          "--augment", "--aug-hflip", "0", "--scatter-impl", "pallas", "--use-pallas-kd"]


def small_distill(monkeypatch):
    """train_distill's configurations with small() students and their 2x
    teachers."""
    real = train_distill.build_configs

    def build(args):
        cfg = small(real(args)[0])
        return cfg, teacher_config(cfg.model, args.teacher_width)
    monkeypatch.setattr(train_distill, "build_configs", build)


def test_train_distill_runs_the_best_recipe(tmp_path, monkeypatch, capsys):
    """scripts/experiment_best_overall.py's flags (without --scan-steps): a
    minimal/128 student, T=4, the standard augmentation without the flip in
    both phases, the cache on the device under a 6 GiB budget, the unsorted
    scatter and the feature-MSE kernel (their plain versions here). One
    teacher epoch and one distill epoch, 6 samples in batches of 4 (the last
    one padded)."""
    cfg, _ = train_distill.build_configs(train_distill.make_parser().parse_args(RECIPE))
    kd, aug = cfg.train.kd, cfg.train.augment
    assert (cfg.model.fusion_type, cfg.model.fusion_out_channels) == ("minimal", 128)
    assert (kd.cache_teacher, kd.cache_hbm_limit_bytes, kd.temperature, kd.use_pallas,
            kd.ensemble_size) == (True, 6 << 30, 4.0, True, 1)
    assert dataclasses.asdict(aug) == dataclasses.asdict(
        AugmentConfig(**{**STANDARD_AUGMENT, "hflip_prob": 0.0}))
    assert cfg.model.lidar.scatter_impl == "pallas"
    small_distill(monkeypatch)
    run = tmp_path / "student"
    best = train_distill.main(RECIPE + ["--device", "cpu", "--epochs", "1", "--teacher-epochs",
                                        "1", "--num-train", "6", "--num-val", "4",
                                        "--batch-size", "4", "--num-workers", "0",
                                        "--save-dir", str(run)])
    out = capsys.readouterr().out
    assert "teacher cache: " in out and "on the device (6 samples" in out
    for d in (run, tmp_path / "student_teacher"):
        hist = json.loads((d / "training_history.json").read_text())
        assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"]).all()
    assert np.isfinite(best)


def test_train_distill_trains_an_ensemble_of_teachers(tmp_path, monkeypatch, capsys):
    """--train-teacher --num-teachers 2: two members with seeds 0 and 1000
    in <save-dir>_teacher and <save-dir>_teacher1, then distillation from
    their average."""
    small_distill(monkeypatch)
    run = tmp_path / "student"
    train_distill.main(["--device", "cpu", "--train-teacher", "--num-teachers", "2",
                        "--epochs", "1", "--save-dir", str(run)] + DATA)
    out = capsys.readouterr().out
    assert "training teacher 1/2" in out and "training teacher 2/2" in out
    members = [torch.load(tmp_path / name / "latest.pth", weights_only=False)["model_state"]
               for name in ("student_teacher", "student_teacher1")]
    assert not all(torch.equal(members[0][k], v) for k, v in members[1].items())
    assert (run / "latest.pth").exists()
    args = train_distill.make_parser().parse_args(["--num-teachers", "2"])
    assert train_distill.build_configs(args)[0].train.kd.ensemble_size == 2
    args = train_distill.make_parser().parse_args(["--teacher-checkpoint", "a.pth",
                                                   "--teacher-checkpoint", "b.pth"])
    kd = train_distill.build_configs(args)[0].train.kd
    assert (kd.teacher_checkpoints, kd.teacher_checkpoint) == (("a.pth", "b.pth"), None)


def test_train_distill_rejects_unported_flags():
    """Teacher partitioning (--teacher-partition, Queue A 8) is not ported:
    argparse rejects its flag. --teacher-lidar-encoder and --scan-steps are
    ported: the teacher's encoder is set on top of teacher_config, the
    student's stays its own."""
    p = train_distill.make_parser()
    with pytest.raises(SystemExit):
        p.parse_args(["--teacher-partition", "fsdp"])
    cfg, tcfg = train_distill.build_configs(p.parse_args(
        ["--lidar-encoder", "pointpillars", "--teacher-lidar-encoder", "spatial",
         "--scan-steps", "13"]))
    assert (cfg.model.lidar.encoder_type, tcfg.lidar.encoder_type) == ("pointpillars", "spatial")
    assert cfg.train.scan_steps == 13 and tcfg.camera.channels[0] == 2 * cfg.model.camera.channels[0]
    cfg, tcfg = train_distill.build_configs(p.parse_args(["--lidar-encoder", "pointpillars"]))
    assert tcfg.lidar.encoder_type == "pointpillars"


def test_train_distill_runs_the_crossarch_recipe_on_device_epochs(tmp_path, monkeypatch,
                                                                    capsys):
    """scripts/experiment_crossarch_best.py's flags with --scan-steps 2 and
    --onchip-epoch at a small size: a PointPillars student, a spatial
    teacher trained first, the cache on the device riding the on-device
    epoch, on-device validation; then a second run with the chunked host
    loop and snapshots."""
    real = train_distill.build_configs

    def build(args):
        cfg, tcfg = real(args)
        cfg = small(cfg)
        t = teacher_config(cfg.model, args.teacher_width)
        return cfg, t.replace(lidar=dataclasses.replace(t.lidar, encoder_type=tcfg.lidar.encoder_type))
    monkeypatch.setattr(train_distill, "build_configs", build)
    flags = ["--lidar-encoder", "pointpillars", "--teacher-lidar-encoder", "spatial",
             "--train-teacher", "--cache-teacher", "--cache-hbm-gb", "6", "--temperature", "4",
             "--augment", "--aug-hflip", "0", "--scan-steps", "2", "--difficulty", "hard",
             "--device", "cpu", "--epochs", "1", "--num-train", "6", "--num-val", "4",
             "--batch-size", "2", "--num-workers", "0"]
    for name, extra in (("onchip", ["--onchip-epoch"]), ("chunked", ["--snapshot-every", "1"])):
        run = tmp_path / name
        best = train_distill.main(flags + extra + ["--save-dir", str(run)])
        assert np.isfinite(best)
        hist = json.loads((run / "training_history.json").read_text())
        assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"]).all()
        ckpt = torch.load(run / "latest.pth", weights_only=False)
        assert any(k.startswith("lidar_encoder.encoder.pfn.") for k in ckpt["model_state"])
        teacher = torch.load(tmp_path / f"{name}_teacher" / "latest.pth", weights_only=False)
        assert any(k.startswith("lidar_encoder.encoder.point_mlp.")
                   for k in teacher["model_state"])
    assert (tmp_path / "chunked" / "epoch_001.pth").exists()
    assert "on the device (6 samples" in capsys.readouterr().out


# -- PandaSet and packs: train_pandaset, prepare_dataset, analyze_distribution --

@pytest.fixture(scope="module")
def pandaset_tree(tmp_path_factory):
    """tests/test_torch_pandaset.py's fabricated tree, without NaN
    coordinates (a NaN point makes the train-mode BatchNorm statistics of
    the point MLP NaN, in the JAX package as in the port)."""
    pytest.importorskip("pandas")
    pytest.importorskip("PIL")
    from test_torch_pandaset import make_pandaset_tree
    return make_pandaset_tree(tmp_path_factory.mktemp("tree"), np.random.default_rng(31),
                              nan=False)


PACK_ARGS = ["--image-size", str(IMG), str(IMG), "--grid-size", str(GRID[0]), str(GRID[1]),
             "--max-points", str(NPTS)]


def _files(d):
    return {str(f.relative_to(d)): f.read_bytes() for f in sorted(d.rglob("*")) if f.is_file()}


@pytest.mark.parametrize("dataset", ["pandaset", "synthetic"])
def test_prepare_dataset_writes_the_jax_scripts_packs(pandaset_tree, tmp_path, monkeypatch,
                                                      capsys, dataset):
    """prepare_dataset with the read-ahead view (2 workers) writes train/
    and val/ packs byte-identical, file for file, to scripts/
    prepare_dataset.py's, without touching CUDA; its closing hint names
    --data-root."""
    import importlib
    import sys
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    jax_prepare = importlib.import_module("scripts.prepare_dataset")
    argv = ["--dataset", dataset, "--root", pandaset_tree, "--workers", "2",
            "--num-train", "3", "--num-val", "2"] + PACK_ARGS

    def no_card(*a, **k):
        raise AssertionError("prepare_dataset touched CUDA")
    with monkeypatch.context() as m:
        for name in ("is_available", "init", "device_count", "synchronize"):
            m.setattr(torch.cuda, name, no_card)
        done = prepare_dataset.main(argv + ["--out", str(tmp_path / "port")])
    assert f"--dataset packed --data-root {tmp_path / 'port'}" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["prepare_dataset.py"] + argv
                        + ["--out", str(tmp_path / "jax")])
    jax_prepare.main()
    assert {s: n for s, (n, _) in done.items()} == \
        ({"train": 4, "val": 3} if dataset == "pandaset" else {"train": 3, "val": 2})
    port, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(port) == (12 if dataset == "pandaset" else 10) and port == jax_files


@pytest.mark.parametrize("argv", [["--dataset", "pandaset", "--num-classes", "2"],
                                  ["--dataset", "pandaset", "--num-classes", "3"],
                                  ["--dataset", "synthetic", "--max-samples", "3"]],
                         ids=["pandaset", "pandaset_3class", "synthetic"])
def test_analyze_distribution_prints_the_jax_scripts_report(pandaset_tree, monkeypatch, capsys,
                                                            argv):
    """The histogram, recommended weights, imbalance warning and drift check
    print exactly as scripts/analyze_distribution.py prints them."""
    import importlib
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    jax_analyze = importlib.import_module("scripts.analyze_distribution")
    argv = argv + ["--data-root", pandaset_tree]
    assert analyze_distribution.main(argv) == 0
    port = capsys.readouterr().out
    assert jax_analyze.main(argv) == 0
    assert port == capsys.readouterr().out
    assert "recommended class weights" in port and "drift" in port


def test_train_pandaset_refuses_a_class_count_off_its_weights():
    """--num-classes must match the preset's three class weights, as in the
    JAX script; the preset itself is concat/256, 3 classes, 30 epochs."""
    p = train_pandaset.make_parser()
    cfg = train_pandaset.build_config(p.parse_args([]), p)
    assert (cfg.model.fusion_type, cfg.model.fusion_out_channels, cfg.model.num_classes,
            cfg.train.class_weights, cfg.train.num_epochs, cfg.data.dataset,
            cfg.train.metrics_num_classes) == \
        ("concat", 256, 3, (0.39, 2.61, 33.09), 30, "pandaset", 2)
    for n in ("2", "4"):
        with pytest.raises(SystemExit):
            train_pandaset.build_config(p.parse_args(["--num-classes", n]), p)


def test_train_pandaset_from_packs_then_evaluate(pandaset_tree, tmp_path, monkeypatch, capsys):
    """prepare_dataset packs the tree; train_pandaset trains the 3-class
    preset one epoch from the packs (sorted scatter, padded point_valid),
    prints the architecture summary and writes its history and checkpoints;
    evaluate with --num-classes 3 --dataset packed reads back the val mIoU
    the trainer recorded (the loss differs: evaluate weighs classes (0.4,
    3.5), as the JAX script does). --resume continues from latest.pth."""
    packs = tmp_path / "packs"
    prepare_dataset.main(["--dataset", "pandaset", "--root", pandaset_tree, "--out", str(packs),
                          "--workers", "0"] + PACK_ARGS)
    monkeypatch.setattr(train_pandaset, "preset_pandaset_weighted",
                        lambda: small(preset_pandaset_weighted()))
    real_eval = evaluate.build_config
    monkeypatch.setattr(evaluate, "build_config", lambda a: small(real_eval(a)))
    run = tmp_path / "run"
    flags = ["--device", "cpu", "--dataset", "packed", "--data-root", str(packs),
             "--batch-size", "2", "--num-workers", "0", "--scatter-impl", "sorted_pallas"]
    best = train_pandaset.main(flags + ["--epochs", "1", "--save-dir", str(run)])
    out = capsys.readouterr().out
    assert "Model architecture:" in out and "fusion_type: concat" in out
    assert "Dataset: packed — 4 train / 3 val samples" in out
    hist = json.loads((run / "training_history.json").read_text())
    assert np.isfinite(hist["train_loss"]).all()
    assert hist["val_miou"] == [best] or best == 0.0
    payload = torch.load(run / "latest.pth", weights_only=False)
    assert payload["model_state"]["head.cls.weight"].shape[0] == 3
    res = evaluate.main(flags + ["--checkpoint", str(run / "latest.pth"), "--num-classes", "3",
                                 "--save-dir", str(tmp_path / "eval")])
    assert np.isfinite(res["loss"]) and res["miou"] == hist["val_miou"][0]
    assert len(res["class_iou"]) == 2
    train_pandaset.main(flags + ["--epochs", "2", "--save-dir", str(run), "--resume"])
    assert len(json.loads((run / "training_history.json").read_text())["val_miou"]) == 2
