"""The plain version of the port's fused InvertedResidual kernel
(ops/ir_fused.py) against the JAX package's fused_ir_infer (Pallas,
interpret mode on the CPU), and the port's InvertedResidual / TwinLite
modules, fused and unfused, against the JAX modules in eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmsu_tpu.config import CameraEncoderConfig as JaxCameraConfig
from lmsu_tpu.models.camera_encoder import TwinLiteEncoder as JaxTwinLite
from lmsu_tpu.models.layers import InvertedResidual as JaxIR
from lmsu_tpu.ops.ir_fused import fused_ir_infer as jax_fused_ir_infer
from lmsu_tpu.ops.ir_fused import params_from_variables
from lmsu_tpu_torch.config import CameraEncoderConfig
from lmsu_tpu_torch.models.camera_encoder import TwinLiteEncoder
from lmsu_tpu_torch.models.layers import InvertedResidual
from lmsu_tpu_torch.ops.ir_fused import IRParams, fused_ir_infer

torch.set_num_threads(2)

VARIANTS = [  # (Cin, Cout, stride, expansion, H), as tests/test_ir_fused.py
    (8, 16, 2, 6, 16),   # stride-2 downsampling stage
    (16, 16, 1, 6, 16),  # residual stage
    (8, 8, 1, 1, 16),    # expansion-1 (stage1 pattern)
]


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _jax_block(rng, Cin, Cout, stride, exp, H):
    x = rng.normal(0, 1, (3, H, H, Cin)).astype(np.float32)
    mod = JaxIR(Cout, (stride, stride), expansion_ratio=exp)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(0, 1, a.shape).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return x, mod, v


def _conv(k):
    """flax conv kernel [kh, kw, I, O] -> torch [O, I, kh, kw]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def _conv_bn_sd(sd, tconv, tbn, p, s):
    sd[f"{tconv}.weight"] = _conv(p["conv"]["kernel"])
    for src, dst in (("scale", "weight"), ("bias", "bias")):
        sd[f"{tbn}.{dst}"] = torch.from_numpy(np.array(p["bn"][src], np.float32))
    for src, dst in (("mean", "running_mean"), ("var", "running_var")):
        sd[f"{tbn}.{dst}"] = torch.from_numpy(np.array(s["bn"][src], np.float32))
    sd[f"{tbn}.num_batches_tracked"] = torch.tensor(0)


def _ir_state_dict(p, s, prefix=""):
    names = (("expand", 0), ("depthwise", 3), ("project", 6)) if "expand" in p \
        else (("depthwise", 0), ("project", 3))
    sd = {}
    for sub, i in names:
        _conv_bn_sd(sd, f"{prefix}conv.{i}", f"{prefix}conv.{i + 1}", p[sub], s[sub])
    return sd


def _to_torch_params(p):
    return IRParams(*(None if a is None else torch.from_numpy(np.array(a, np.float32))
                      for a in p))


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_kernel_matches_jax_fused(rng, variant):
    x, _, v = _jax_block(rng, *variant)
    jp = params_from_variables(v)
    want = np.asarray(jax_fused_ir_infer(jnp.asarray(x), jp, stride=variant[2]))
    got = fused_ir_infer(torch.from_numpy(x), _to_torch_params(jp), stride=variant[2])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_kernel_bf16_matches_jax_fused(rng, variant):
    """bf16: e, the taps and d round to bf16 at the same places on both
    sides; f32 summation order can move one intermediate across a rounding
    boundary (tolerance: a few bf16 steps at the output's scale)."""
    x, _, v = _jax_block(rng, *variant)
    jp = params_from_variables(v)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_fused_ir_infer(xb, jp, stride=variant[2]).astype(jnp.float32))
    got = fused_ir_infer(torch.from_numpy(x).bfloat16(), _to_torch_params(jp), variant[2])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05 * max(1, np.abs(want).max()))


@pytest.mark.parametrize("variant", VARIANTS)
def test_module_fused_and_unfused_match_jax_eval(rng, variant):
    Cin, Cout, stride, exp, H = variant
    x, mod, v = _jax_block(rng, *variant)
    want = np.asarray(mod.apply(v, jnp.asarray(x), train=False))
    sd = _ir_state_dict(v["params"], v["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for fused in (True, False):
        block = InvertedResidual(Cin, Cout, stride, exp, fused_inference=fused)
        block.load_state_dict(sd, strict=True)
        block.eval()
        with torch.no_grad():
            got = block(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    folded = block.folded_params()
    for a, b in zip(folded, params_from_variables(v)):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_folded_params_refold_after_weight_change(rng):
    x, _, v = _jax_block(rng, *VARIANTS[1])
    block = InvertedResidual(16, 16, 1, 6, fused_inference=True).eval()
    block.load_state_dict(_ir_state_dict(v["params"], v["batch_stats"]))
    first = block.folded_params()
    assert block.folded_params() is first  # cached while nothing changes
    with torch.no_grad():
        block.conv[1].running_var.mul_(2.0)
    assert not torch.equal(block.folded_params().s1, first.s1)


def test_whole_encoder_fused_and_unfused_match_jax(rng):
    """TwinLite (default widths) with randomised BN statistics, running
    means centred (N(0, 0.2), as chip_smoke.py::randomize_bn draws them) and
    variances U(0.5, 2.0): every stage of the port's encoder, both paths,
    against the JAX encoder in eval. Each compared map must vary over
    pixels (means drawn from the variances' law zero the stem's ReLU6 and
    leave every stage spatially constant)."""
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    enc = JaxTwinLite(JaxCameraConfig())
    v = enc.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)

    def stat(path, a):
        if path[-1].key == "mean":
            return rng.normal(0, 0.2, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": jax.tree_util.tree_map_with_path(stat, v["batch_stats"])}
    with jax.default_matmul_precision("highest"):
        want = enc.apply(v, jnp.asarray(x), train=False)
    for k in want:
        w = np.asarray(want[k], np.float64)
        assert w.std(axis=(1, 2)).max() > 1e-2 * max(1.0, np.abs(w).max()), k
    p, s = v["params"], v["batch_stats"]
    sd = {}
    _conv_bn_sd(sd, "stem.0", "stem.1", p["stem"], s["stem"])
    for k in range(1, 6):
        sd.update(_ir_state_dict(p[f"stage{k}"], s[f"stage{k}"], f"stage{k}."))
    for fused in (True, False):
        port = TwinLiteEncoder(CameraEncoderConfig(fused_inference=fused)).eval()
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        for k in want:
            np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                       np.asarray(want[k]), atol=1e-4, rtol=1e-5)
