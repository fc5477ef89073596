"""The PyTorch port stands alone: it imports neither jax/flax nor msgpack nor
anything of the JAX package or its scripts/, nor matplotlib when a module is
imported (the host tools import it to draw), its entry points run on CUDA
unless asked for the CPU,
and its kernel wrappers never fall back to the plain version for a tensor
that is not on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "lmsu_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "lmsu_tpu", "scripts", "bench",
             "lightweight_multi_modal_scene_understanding_via_knowledge_distillation_tpu"}
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Every module of the port (and chip_smoke.py) imports in a process
    where jax, flax, the JAX package and its scripts/ cannot be imported at
    all, and none of them imports matplotlib (the host tools, experiments/
    among the modules walked, import it only to draw)."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, lmsu_tpu_torch\n"
        "for m in pkgutil.walk_packages(lmsu_tpu_torch.__path__, 'lmsu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r} and sys.modules[m] is not None]\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


# The last of the scripts' counterparts: the nine experiments,
# summarize_experiments, the serving, frozen-predictor and input benches and
# the dress rehearsal (the root bench.py's bench_shapes is copied, not
# imported).
LAST_MODULES = tuple(f"lmsu_tpu_torch/experiments/{n}.py" for n in (
    "augment", "augment_noisy", "best_recipe", "teacher_scaling", "capacity_gap",
    "ta_chain", "ema", "gated_sum", "quant_accuracy")) + tuple(
    f"lmsu_tpu_torch/{n}.py" for n in ("summarize_experiments", "bench_serving",
                                       "bench_frozen_predictor", "bench_input_pipeline",
                                       "dress_rehearsal"))


@pytest.mark.parametrize("name", LAST_MODULES)
def test_last_modules_are_checked_and_import_nothing_of_jax(name):
    """Each of the 14 is among the sources checked above and imports no jax,
    no lmsu_tpu, nothing of scripts/ and not the root bench.py."""
    path = ROOT / name
    assert path in SOURCES
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in {"jax", "lmsu_tpu", "scripts", "bench"}]
    assert not bad, f"{name} imports {bad}"


def test_parallel_modules_are_checked_and_refuse_a_missing_gpu(monkeypatch):
    """parallel/* and run_multiprocess.py are among the sources checked
    above (and imported with JAX blocked); a rank that asks for CUDA
    without it raises instead of dropping to the CPU, as does the
    multi-process run, whose ranks run on CUDA unless --device cpu says."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"lmsu_tpu_torch/parallel/__init__.py", "lmsu_tpu_torch/parallel/mesh.py",
            "lmsu_tpu_torch/parallel/tp.py", "lmsu_tpu_torch/run_multiprocess.py"} <= names
    from lmsu_tpu_torch import run_multiprocess
    from lmsu_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_multiprocess.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_multiprocess.main([])
    assert mesh.active() is None


def _tiny_config():
    from lmsu_tpu_torch.config import (CameraEncoderConfig, LidarEncoderConfig,
                                       ModelConfig)
    return ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
                       camera_fpn_channels=16,
                       camera=CameraEncoderConfig(base_channels=4),
                       lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                grid_size=(8, 8)))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from lmsu_tpu_torch import serve, train_distill
    from lmsu_tpu_torch.config import ExperimentConfig
    from lmsu_tpu_torch.inference import Predictor
    from lmsu_tpu_torch.training import DistillationTrainer, Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(_tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_engine(serve.parse_args([]))
    assert train_distill.make_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        train_distill.main(["--epochs", "1"])
    cfg = ExperimentConfig(model=_tiny_config())
    for trainer in (Trainer, DistillationTrainer):
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer(cfg, [], [])
    # Asked for explicitly, the CPU runs.
    pred = Predictor(_tiny_config(), device="cpu")
    assert pred.device.type == "cpu"


def test_wrappers_refuse_non_cpu_tensors_without_fallback():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is only for CPU tensors (meta tensors stand in here for a
    device this host has no kernel for)."""
    from lmsu_tpu_torch.ops.fusion_gate import fusion_gate
    from lmsu_tpu_torch.ops.ir_fused import IRParams, fused_ir_infer
    from lmsu_tpu_torch.ops.kd_loss import fused_feature_mse, mse_partials
    from lmsu_tpu_torch.ops.scatter_sorted import (bev_scatter_max_sorted_pallas, segment_max,
                                                   segment_max_bwd)
    m = dict(device="meta")
    keys = torch.empty(1, 4, dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        segment_max(torch.empty(1, 4, 8, **m), keys, 16)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        segment_max_bwd(torch.empty(1, 4, 8, **m), keys, torch.empty(1, 16, 8, **m),
                        torch.empty(1, 16, 8, **m), 16)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bev_scatter_max_sorted_pallas(torch.empty(1, 4, 8, **m),
                                      torch.empty(1, 4, dtype=torch.long, **m),
                                      torch.empty(1, 4, dtype=torch.bool, **m), (4, 4))
    s, t, proj = torch.empty(1, 16, 8, **m), torch.empty(1, 16, 12, **m), torch.empty(12, 8, **m)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mse_partials(s, t, proj)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_feature_mse(s, t, proj)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fusion_gate(torch.empty(1, 2, 2, 32, **m), torch.empty(1, 2, 2, 32, **m),
                    torch.empty(32, 64, 1, 1, **m), torch.empty(32, **m),
                    torch.empty(2, 32, 1, 1, **m), torch.empty(2, **m))
    e = torch.empty(8, **m)
    p = IRParams(None, None, None, torch.empty(3, 3, 8, **m), e, e,
                 torch.empty(8, 8, **m), e, e)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_ir_infer(torch.empty(1, 4, 4, 8, **m), p, 1)


def test_scatter_family_wrappers_refuse_non_cpu_tensors_without_fallback(monkeypatch):
    """K6 (the unsorted scatter-max of scatter_impl="pallas") and K4 (the
    flat sorted forward, also when segment_max takes it under _FWD_FLAT):
    a meta tensor raises, none falls back to the plain version."""
    from lmsu_tpu_torch.ops import scatter_sorted as ss
    from lmsu_tpu_torch.ops.voxelize import bev_scatter_max_pallas, scatter_max
    m = dict(device="meta")
    feats, keys = torch.empty(1, 4, 8, **m), torch.empty(1, 4, dtype=torch.int32, **m)
    monkeypatch.setattr(ss, "_FWD_FLAT", True)
    calls = {
        "scatter_max": lambda: scatter_max(feats, keys, 16),
        "bev_scatter_max_pallas": lambda: bev_scatter_max_pallas(
            feats, torch.empty(1, 4, dtype=torch.long, **m),
            torch.empty(1, 4, dtype=torch.bool, **m), (4, 4)),
        "segment_max_flat": lambda: ss.segment_max_flat(feats, keys, 16),
        "segment_max under _FWD_FLAT": lambda: ss.segment_max(feats, keys, 16),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_training_block_wrappers_refuse_non_cpu_tensors_without_fallback():
    """K8-K13 and the fused training block: a meta tensor raises, none falls
    back to the plain version."""
    from lmsu_tpu_torch.ops import ir_fused as irf
    m = dict(device="meta")
    x, d, e = torch.empty(2, 4, 4, 8, **m), torch.empty(2, 4, 4, 16, **m), torch.empty(16, **m)
    w1, dw, w2 = torch.empty(8, 16, **m), torch.empty(3, 3, 16, **m), torch.empty(16, 8, **m)
    y = torch.empty(2, 4, 4, 8, **m)
    calls = {
        "stats1": lambda: irf.stats1(x, w1),
        "expand_dw": lambda: irf.expand_dw(x, w1, e, e, dw, 1),
        "proj": lambda: irf.proj(d, e, e, w2),
        "proj_bwd": lambda: irf.proj_bwd(d, y, e, e, e, e, w2),
        "dw_bwd": lambda: irf.dw_bwd(x, w1, e, e, e, e, dw, d, e, e, e, d, e, e, 1),
        "expand_bwd": lambda: irf.expand_bwd(x, w1, e, e, e, e, e, d),
        "fused_ir_train": lambda: irf.fused_ir_train(
            x, w1, e, e, dw, e, e, w2, torch.empty(8, **m), torch.empty(8, **m), 1, True),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_create_model_takes_fused_train_and_refuses_the_rest():
    """fused_train, remat (with fused_train too) and the deprecated
    LidarEncoderConfig.use_pallas (the "pallas" scatter, as in the JAX
    package) build."""
    from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
    from lmsu_tpu_torch.models import create_model
    cfg = _tiny_config()
    model = create_model(cfg.replace(camera=CameraEncoderConfig(base_channels=4,
                                                                fused_train=True)))
    assert all(getattr(model.camera_encoder, f"stage{i}").fused_train for i in range(1, 6))
    lidar = LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16), grid_size=(8, 8),
                               use_pallas=True)
    assert create_model(cfg.replace(lidar=lidar)).lidar_encoder.encoder.config.use_pallas
    model = create_model(cfg.replace(camera=CameraEncoderConfig(base_channels=4, remat=True,
                                                                fused_train=True)))
    assert model.camera_encoder.config.remat and model.camera_encoder.stage3.fused_train
    assert isinstance(ModelConfig().camera.fused_train, bool)


def test_kernel_build_flags_and_sources():
    """Each kernel source exists and builds for sm_90a without fast math,
    into a build directory that git ignores; each shared header is included
    by the sources that share it, and its text is part of every library's
    build hash."""
    from lmsu_tpu_torch.ops import _cuda
    ks = _cuda.kernels()
    assert set(ks) == {"scatter_sorted_fwd", "scatter_sorted_fwd_flat", "scatter_sorted_bwd",
                       "voxelize_scatter_max", "fusion_gate", "ir_fused_infer",
                       "kd_feature_mse", "ir_train_stats1", "ir_train_expand_dw",
                       "ir_train_proj", "ir_train_proj_bwd", "ir_train_dw_bwd",
                       "ir_train_expand_bwd"}
    for k in ks.values():
        assert (_cuda.CSRC / k.source).is_file()
        for sym in k.symbols:
            assert f'extern "C" int {sym}(' in (_cuda.CSRC / k.source).read_text()
    flags = " ".join(_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "fast_math" not in flags
    assert _cuda.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "/build/" in (ROOT / ".gitignore").read_text().split()
    users = {"ir_train_common.cuh": [k for k in ks.values() if k.name.startswith("ir_train")],
             "scatter_sorted_common.cuh": [ks["scatter_sorted_fwd"], ks["scatter_sorted_bwd"],
                                           ks["scatter_sorted_fwd_flat"]]}
    assert {h.name for h in _cuda.CSRC.glob("*.cuh")} == set(users)
    assert all(f'#include "{h}"' in (_cuda.CSRC / k.source).read_text()
               for h, sources in users.items() for k in sources)


def test_build_skipped_without_nvcc_is_an_error(monkeypatch):
    """Building is never silently skipped: without nvcc it raises."""
    import torch.utils.cpp_extension as cpp_extension

    from lmsu_tpu_torch.ops import _cuda
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda._nvcc()
