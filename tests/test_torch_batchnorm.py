"""Train-mode BatchNorm of the port against flax's (flax 0.12), on the CPU.

One train-mode forward of the whole model updates every BatchNorm's
running_mean / running_var as flax updates `batch_stats`: with the BIASED
batch variance and momentum 0.9 (torch's own BatchNorm would take the
unbiased variance). Tolerance: rtol 1e-5, atol 1e-6 on the statistics
(flax reduces the variance as E[x^2] - E[x]^2, the port in two passes;
both in f32); train-mode logits rtol 1e-3, atol 5e-4, the bar of the
port's eval-mode logits (tests/test_torch_model.py)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import jax_init_model

from lmsu_tpu.config import CameraEncoderConfig as JCam
from lmsu_tpu.config import LidarEncoderConfig as JLidar
from lmsu_tpu.config import ModelConfig as JModel
from lmsu_tpu.models import create_model as jax_create_model
from lmsu_tpu_torch.config import CameraEncoderConfig, LidarEncoderConfig, ModelConfig
from lmsu_tpu_torch.models import create_model
from lmsu_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d
from lmsu_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

IMG, NPTS, GRID = 64, 300, (16, 16)


@pytest.fixture
def rng():
    return np.random.default_rng(4242)


def _configs():
    kw = dict(num_classes=2, fusion_type="weighted", fusion_out_channels=16,
              camera_fpn_channels=16)
    lid = dict(feature_dim=16, mlp_dims=(8, 16), grid_size=GRID)
    return (JModel(camera=JCam(base_channels=8), lidar=JLidar(**lid), **kw),
            ModelConfig(camera=CameraEncoderConfig(base_channels=8),
                        lidar=LidarEncoderConfig(**lid), **kw))


def test_train_forward_updates_running_stats_like_flax(rng):
    jcfg, pcfg = _configs()
    jm = jax_create_model(jcfg)
    v = jax_init_model(jm, 0)
    # Running statistics away from their init, so the momentum term shows.
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v["batch_stats"])
    images = rng.uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    pts = rng.normal(0, 30, (2, NPTS, 4)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        j_logits, mut = jax.jit(lambda v, i, p: jm.apply(v, i, p, train=True,
                                                         mutable=["batch_stats"]))(
            v, jnp.asarray(images), jnp.asarray(pts))
    want = from_jax_variables({"params": v["params"],
                               "batch_stats": jax.device_get(mut["batch_stats"])}, pcfg)

    model = create_model(pcfg)
    model.load_state_dict(from_jax_variables(v, pcfg))
    model.train()
    logits = model(torch.from_numpy(images), torch.from_numpy(pts))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               rtol=1e-3, atol=5e-4)
    sd = model.state_dict()
    n_bn = 0
    for name, m in model.named_modules():
        if isinstance(m, (BatchNorm1d, BatchNorm2d)):
            n_bn += 1
            for buf in ("running_mean", "running_var"):
                np.testing.assert_allclose(sd[f"{name}.{buf}"].numpy(),
                                           want[f"{name}.{buf}"].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{name}.{buf}")
            assert int(m.num_batches_tracked) == 1
    assert n_bn == 29  # every BatchNorm of the model (camera 15, FPN 5, LiDAR 3, fusion 2, head 4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_single_batchnorm2d_matches_flax(rng, dtype):
    """Normalisation with the biased batch statistics, reduced in f32 for
    bf16 input, output in the input dtype; running stats as flax."""
    x = (rng.normal(2.0, 3.0, (4, 6, 5, 7))).astype(np.float32)  # NCHW
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.5, 6).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                       torch.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    jx = jnp.asarray(x.transpose(0, 2, 3, 1), jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.full(6, 0.3), "var": jnp.full(6, 2.0)}}
    jy, mut = bn.apply(variables, jx, mutable=["batch_stats"])

    m = BatchNorm2d(6, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.fill_(0.3)
        m.running_var.fill_(2.0)
    y = m.train()(torch.from_numpy(x).to(tdt))
    assert y.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(y.float().detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    # torch's own BatchNorm takes the unbiased variance: the repair matters.
    n = x.size // 6
    ref = torch.nn.BatchNorm2d(6, momentum=0.1)
    ref.running_var.fill_(2.0)
    ref.train()(torch.from_numpy(x).to(tdt).float())
    assert not np.allclose(ref.running_var.numpy(), m.running_var.numpy(), rtol=1e-4)
    np.testing.assert_allclose((ref.running_var.numpy() - 0.9 * 2.0) * (n - 1) / n,
                               m.running_var.numpy() - 0.9 * 2.0, rtol=1e-4)


def test_eval_mode_is_torch_batchnorm(rng):
    x = torch.from_numpy(rng.normal(0, 1, (2, 4, 9)).astype(np.float32))
    m, ref = BatchNorm1d(4), torch.nn.BatchNorm1d(4)
    with torch.no_grad():
        for b in (m, ref):
            b.running_mean.copy_(torch.arange(4.0))
            b.running_var.copy_(torch.arange(1.0, 5.0))
    assert torch.equal(m.eval()(x), ref.eval()(x))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_relu6_gradient_splits_ties_like_jax(rng, dtype):
    """The port's ReLU6 against jax.grad of the JAX package's relu6
    (min(max(x, 0), 6)) on inputs with exact 0s and 6s, where the derivative
    is 1/2. Exact: the forward and the derivative take no rounding."""
    from lmsu_tpu.models.layers import relu6 as jax_relu6
    from lmsu_tpu_torch.models.layers import ReLU6
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    x = np.concatenate([[-1.0, 0.0, -0.0, 3.0, 6.0, 7.0], rng.normal(0, 4, 500)])
    x[rng.integers(0, len(x), 50)] = 0.0
    x[rng.integers(0, len(x), 50)] = 6.0
    g = rng.normal(0, 1, x.shape)
    want_y, vjp = jax.vjp(jax_relu6, jnp.asarray(x, jdt))
    want_dx, = vjp(jnp.asarray(g, jdt))
    xt = torch.tensor(x, dtype=tdt, requires_grad=True)
    y = ReLU6()(xt)
    y.backward(torch.tensor(g, dtype=tdt))
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want_dx, np.float32))
