"""CameraEncoderConfig.remat in the port (flax's nn.remat around each
InvertedResidual stage, lmsu_tpu/models/camera_encoder.py:51-53), on the
CPU: one train-mode step of a small pillar model with remat against the
same step without it, unfused and with fused_train (K8-K13's plain
versions here). The remat step recomputes each stage's forward in the
backward pass, so it runs the same ops on the same numbers: the loss, every
gradient and every BatchNorm buffer after the step are equal bit for bit,
and num_batches_tracked shows the running statistics moved once, not
twice, both with torch.utils.checkpoint's early stop (its default) and with
each stage's forward re-run to its end. In eval mode and without autograd
remat changes nothing."""

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models import layers

torch.set_num_threads(2)


def _config(remat, fused_train):
    return ModelConfig(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
                       camera_fpn_channels=16,
                       camera=CameraEncoderConfig(base_channels=8, remat=remat,
                                                  fused_train=fused_train),
                       lidar=LidarEncoderConfig(feature_dim=16, mlp_dims=(8, 16),
                                                grid_size=(8, 8), encoder_type="pointpillars"))


def _inputs():
    rng = np.random.default_rng(4)
    return (torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)),
            torch.from_numpy(rng.normal(0, 30, (2, 128, 4)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (2, 8, 8))))


def _step(remat, fused_train, early_stop=True):
    """(loss, gradients, buffers, how many stage forwards ran) of one
    train-mode step from seed 0's weights. Without `early_stop`
    torch.utils.checkpoint re-runs each stage's forward to its end (by
    default it stops once the backward has what it needs, which can be
    before a stage's statistics update)."""
    model = create_model(_config(remat, fused_train), seed=0).train()
    calls = []
    for i in range(1, 6):
        getattr(model.camera_encoder, f"stage{i}").register_forward_pre_hook(
            lambda m, a: calls.append(1))
    images, points, labels = _inputs()
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        logits = model(images, points)
        loss = torch.nn.functional.cross_entropy(logits.permute(0, 3, 1, 2), labels)
        loss.backward()
    return (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
            {k: v.clone() for k, v in model.named_buffers()}, len(calls))


@pytest.mark.parametrize("early_stop", [True, False], ids=["early_stop", "full_rerun"])
@pytest.mark.parametrize("fused_train", [False, True], ids=["unfused", "fused_train"])
def test_remat_step_equals_plain_step(fused_train, early_stop):
    loss, grads, bufs, calls = _step(False, fused_train)
    r_loss, r_grads, r_bufs, r_calls = _step(True, fused_train, early_stop)
    assert (calls, r_calls) == (5, 10)  # remat re-ran every stage in the backward
    assert torch.equal(r_loss, loss)
    for k, g in grads.items():
        assert torch.equal(r_grads[k], g), k
    for k, b in bufs.items():
        assert torch.equal(r_bufs[k], b), k
    # Each train-mode BN moved once in the step.
    tracked = {k: int(v) for k, v in r_bufs.items() if k.endswith("num_batches_tracked")}
    assert set(tracked.values()) == {1}, tracked


def test_remat_changes_nothing_in_eval_or_without_grad():
    images, points, _ = _inputs()
    outs = []
    for remat in (False, True):
        model = create_model(_config(remat, False), seed=0)
        with torch.no_grad():
            train_out = model.train()(images, points)
        outs.append((model.eval()(images, points).detach(), train_out,
                     {k: v.clone() for k, v in model.named_buffers()}))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(outs[0][2][k], v) for k, v in outs[1][2].items())


def test_recomputing_flag_is_scoped():
    """`recomputing()` is on only inside remat's re-run of the forward."""
    seen = []

    def fn(x):
        seen.append(layers.recomputing())
        return torch.sin(x)
    x = torch.ones(3, requires_grad=True)
    layers.remat(fn, x).sum().backward()
    assert seen == [False, True] and not layers.recomputing()
    assert torch.equal(x.grad, torch.cos(torch.ones(3)))
