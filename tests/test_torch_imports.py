"""The PyTorch port stands alone: it imports neither jax/flax nor anything of
the JAX package, its entry points run on CUDA unless asked for the CPU,
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
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lmsu_tpu",
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
    where jax, flax and the JAX package cannot be imported at all."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, lmsu_tpu_torch\n"
        "for m in pkgutil.walk_packages(lmsu_tpu_torch.__path__, 'lmsu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r} and sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def _tiny_config():
    from lmsu_tpu_torch.config import (CameraEncoderConfig, LidarEncoderConfig,
                                       ModelConfig)
    return ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
                       camera_fpn_channels=16,
                       camera=CameraEncoderConfig(base_channels=4),
                       lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                grid_size=(8, 8)))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from lmsu_tpu_torch import serve
    from lmsu_tpu_torch.inference import Predictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(_tiny_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_engine(serve.parse_args([]))
    # Asked for explicitly, the CPU runs.
    pred = Predictor(_tiny_config(), device="cpu")
    assert pred.device.type == "cpu"


def test_wrappers_refuse_non_cpu_tensors_without_fallback():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is only for CPU tensors (meta tensors stand in here for a
    device this host has no kernel for)."""
    from lmsu_tpu_torch.ops.fusion_gate import fusion_gate
    from lmsu_tpu_torch.ops.ir_fused import IRParams, fused_ir_infer
    from lmsu_tpu_torch.ops.scatter_sorted import segment_max
    m = dict(device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        segment_max(torch.empty(1, 4, 8, **m), torch.empty(1, 4, dtype=torch.int32, **m), 16)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fusion_gate(torch.empty(1, 2, 2, 32, **m), torch.empty(1, 2, 2, 32, **m),
                    torch.empty(32, 64, 1, 1, **m), torch.empty(32, **m),
                    torch.empty(2, 32, 1, 1, **m), torch.empty(2, **m))
    e = torch.empty(8, **m)
    p = IRParams(None, None, None, torch.empty(3, 3, 8, **m), e, e,
                 torch.empty(8, 8, **m), e, e)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_ir_infer(torch.empty(1, 4, 4, 8, **m), p, 1)


def test_kernel_build_flags_and_sources():
    """Each kernel source exists and builds for sm_90a without fast math,
    into a build directory that git ignores."""
    from lmsu_tpu_torch.ops import _cuda
    ks = _cuda.kernels()
    assert set(ks) == {"scatter_sorted_fwd", "fusion_gate", "ir_fused_infer"}
    for k in ks.values():
        assert (_cuda.CSRC / k.source).is_file()
        for sym in k.symbols:
            assert f'extern "C" int {sym}(' in (_cuda.CSRC / k.source).read_text()
    flags = " ".join(_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "fast_math" not in flags
    assert _cuda.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "/build/" in (ROOT / ".gitignore").read_text().split()


def test_build_skipped_without_nvcc_is_an_error(monkeypatch):
    """Building is never silently skipped: without nvcc it raises."""
    import torch.utils.cpp_extension as cpp_extension

    from lmsu_tpu_torch.ops import _cuda
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda._nvcc()
