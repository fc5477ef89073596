"""Shape limits of the port's kernels that the JAX package's kernels do not
have, and the f32 precision the CLIs pin.

Each limit that remains is refused by name, with the option that hits it,
before anything runs on the card: the check functions are called here
directly, and `check_kernel_shapes` (what the trainers and the Predictor
call when their device is CUDA) is held to refuse a fused block by its
module name. The limits the kernels lifted (K9's shared memory, K13's Cin
<= 128, K2's C in {32, 64, 128, 256}) pass, and K2 takes every C. The
CLIs' start-up turns TF32 off for cuDNN and cuBLAS, so that their f32 is
the f32 parity is held at.
"""

import pytest
import torch

from lmsu_tpu_torch import (evaluate, serve, train_distill, train_fusion_ablation,
                            train_synthetic)
from lmsu_tpu_torch.config import CameraEncoderConfig, ModelConfig, teacher_config
from lmsu_tpu_torch.models.camera_encoder import TwinLiteEncoder
from lmsu_tpu_torch.models.factory import check_kernel_shapes
from lmsu_tpu_torch.models.fusion import WeightedFusion
from lmsu_tpu_torch.ops import fusion_gate as fg
from lmsu_tpu_torch.ops.ir_fused import (check_fused_infer, check_fused_train,
                                         fused_infer_limits, fused_train_limits)
from lmsu_tpu_torch.ops.kd_loss import check_kd_feature_mse, kd_feature_mse_limits
from lmsu_tpu_torch.training.distill import tap_channels

torch.set_num_threads(2)

# (Cin, Ce, Cout, stride) of the student's five stages and the 2x teacher's.
STUDENT = [(32, 32, 32, 1), (32, 192, 64, 2), (64, 384, 64, 1), (64, 384, 128, 2),
           (128, 768, 128, 1)]
TEACHER = [(64, 64, 64, 1), (64, 384, 128, 2), (128, 768, 128, 1), (128, 768, 256, 2),
           (256, 1536, 256, 1)]


@pytest.mark.parametrize("cin,ce,cout,stride", STUDENT + TEACHER)
def test_fused_train_takes_the_student_and_teacher_widths(cin, ce, cout, stride):
    assert fused_train_limits(cin, ce, ce != cin) == []
    check_fused_train("stage", cin, ce, ce != cin)


@pytest.mark.parametrize("cin,ce,has_expand,what", [
    (12, 72, True, "Cin=12"),        # 16-byte rows of x
    (32, 48, True, "Ce=48"),         # K12's 32-channel items
    (16, 16, False, "Ce=16"),
    (512, 3072, True, "K13"),       # no 64-channel group fits K13's shared memory
    (640, 1280, True, "K8"),        # K8's 64-pixel tile overflows its shared memory
])
def test_fused_train_refuses_by_name(cin, ce, has_expand, what):
    with pytest.raises(ValueError, match=r"camera stage4: .*fused_train=True.*" + what):
        check_fused_train("camera stage4", cin, ce, has_expand)


def test_fused_train_lifted_limits():
    """K13 took Cin <= 128 and K9 refused wide halos; both now take them."""
    for cin in (160, 256, 320):
        assert fused_train_limits(cin, 6 * cin, True) == []


def test_fused_inference_takes_the_student_widths():
    for cin, ce, cout, stride in STUDENT:
        assert fused_infer_limits(cin, ce, cout, stride) == []


@pytest.mark.parametrize("cin,ce,cout,stride", TEACHER)
def test_fused_inference_takes_the_teacher_widths(cin, ce, cout, stride):
    """K3 took the 2x teacher's stages but its fourth (128 -> 256 at stride
    2), which overflowed a block's shared memory; since its weights may be
    read from L2 where their rings do not fit, it takes all five."""
    assert fused_infer_limits(cin, ce, cout, stride) == []
    check_fused_infer("stage", cin, ce, cout, stride)


@pytest.mark.parametrize("cin,ce,cout,stride,what", [
    (256, 1536, 256, 2, "shared memory"),  # a 256-channel halo at stride 2
    (256, 1536, 512, 1, "Cout=512"),
    (30, 180, 64, 2, "multiples of 4"),
])
def test_fused_inference_refuses_by_name(cin, ce, cout, stride, what):
    with pytest.raises(ValueError, match=r"stage4: .*fused_inference=True.*" + what):
        check_fused_infer("stage4", cin, ce, cout, stride)


def test_kd_feature_mse_limits():
    assert kd_feature_mse_limits(128, 256) == []   # the 2x teacher
    assert kd_feature_mse_limits(128, 512) == []   # 4x
    check_kd_feature_mse("camera_feat", 128, 512, 4.0)
    with pytest.raises(ValueError, match=r"'post_fusion'.*teacher_width_mult=8.*Ct=1024"):
        check_kd_feature_mse("post_fusion", 128, 1024, 8.0)
    with pytest.raises(ValueError, match=r"'lidar_feat'.*teacher_width_mult=1\.5.*Cs=12"):
        check_kd_feature_mse("lidar_feat", 12, 48, 1.5)


def test_kd_feature_mse_sees_the_concat_taps():
    """The concat/256 student's KD taps: with its 2x teacher every tap fits
    K7 (post_fusion Cs 256 / Ct 512, at the limit); with a 4x teacher
    post_fusion (Ct 1,024) is refused by name, the other taps still fit."""
    student = ModelConfig(num_classes=2)
    s = tap_channels(student)
    for mult in (2.0, 4.0):
        t = tap_channels(teacher_config(student, mult))
        for tap in ("camera_feat", "lidar_feat"):
            check_kd_feature_mse(tap, s[tap], t[tap], mult)
        if mult == 2.0:
            assert (s["post_fusion"], t["post_fusion"]) == (256, 512)
            check_kd_feature_mse("post_fusion", s["post_fusion"], t["post_fusion"], mult)
        else:
            with pytest.raises(ValueError, match=r"'post_fusion'.*=4.*Ct=1024"):
                check_kd_feature_mse("post_fusion", s["post_fusion"], t["post_fusion"], mult)


def test_check_kernel_shapes_names_the_stage():
    """A narrow encoder with fused_train: its expansion-1 stage has Ce = 8,
    which K12 does not take. Refused for CUDA (before any launch), not for
    the CPU, whose plain versions take any width; an eval-only model is
    held to fused_inference's limits only."""
    enc = TwinLiteEncoder(CameraEncoderConfig(base_channels=8, fused_train=True))
    with pytest.raises(ValueError, match=r"stage1: .*fused_train=True.*Ce=8"):
        check_kernel_shapes(enc, torch.device("cuda"))
    check_kernel_shapes(enc, torch.device("cpu"))
    check_kernel_shapes(enc, torch.device("cuda"), train=False)
    check_kernel_shapes(TwinLiteEncoder(CameraEncoderConfig(fused_train=True)),
                        torch.device("cuda"))


@pytest.mark.parametrize("C", [48, 512])
def test_fusion_gate_takes_any_channel_count(C):
    """K2's wrapper refused C outside {32, 64, 128, 256}; the kernel now
    walks output-channel tiles. On the CPU the plain version runs."""
    g = torch.Generator().manual_seed(C)
    cam, lid = torch.randn(2, 3, 3, C, generator=g), torch.randn(2, 3, 3, C, generator=g)
    w1 = torch.randn(C, 2 * C, 1, 1, generator=g) * 0.05
    b1, w2, b2 = torch.randn(C, generator=g), torch.randn(2, C, 1, 1, generator=g), \
        torch.randn(2, generator=g)
    out = fg.fusion_gate_fwd(cam, lid, w1, b1, w2, b2)
    assert out.shape == cam.shape and torch.isfinite(out).all()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli,builder,argv", [
    (train_distill, "build_configs", ["--device", "cpu"]),
    (serve, "build_engine", ["--device", "cpu"]),
    (train_synthetic, "build_config", ["--device", "cpu"]),
    (train_fusion_ablation, "train_variant", ["--device", "cpu"]),
    (evaluate, "build_config", ["--device", "cpu", "--checkpoint", "latest.pth"]),
])
def test_cli_setup_turns_tf32_off(monkeypatch, cli, builder, argv):
    """Each CLI pins full f32 before it builds anything: the flags are on
    when main starts and off when it reaches its first builder."""
    seen = {}

    def stop(*_a, **_k):
        seen["flags"] = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
        raise _Stop

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(cli, builder, stop)
    with pytest.raises(_Stop):
        cli.main(argv)
    assert seen["flags"] == (False, False)


@pytest.mark.parametrize("C,dtype", [
    (128, torch.float32), (256, torch.float32), (512, torch.float32), (520, torch.float32),
    (1024, torch.bfloat16), (1040, torch.bfloat16),
])
def test_fused_gate_of_any_width_is_taken(C, dtype):
    """K2 takes every C: where a 32-row tile of [cam | lid] overflows a
    block's shared memory (past 512 channels in f32, 1,024 in bf16) it
    streams x through its ring instead. So `check_kernel_shapes` refuses no
    fused gate when a model is set up on CUDA, and the wrapper's CPU path
    runs at that width in that dtype."""
    model = torch.nn.ModuleDict({"fusion": WeightedFusion(8, 8, C, use_fused_gate=True)})
    check_kernel_shapes(model, torch.device("cuda"))
    g = torch.Generator().manual_seed(C)
    cam, lid = (torch.randn(1, 2, 2, C, generator=g).to(dtype) for _ in range(2))
    a0, a2 = model["fusion"].attention[0], model["fusion"].attention[2]
    out = fg.fusion_gate_fwd(cam, lid, a0.weight, a0.bias, a2.weight, a2.bias)
    assert out.shape == cam.shape and out.dtype == dtype and torch.isfinite(out.float()).all()
