"""The port's frozen-BN folded conv and maxpool vs the JAX package's."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as fnn

from adaptsegnet_tpu.models.layers import (
    conv_bn_folded as jax_conv_bn_folded,
    max_pool_3x3_s2 as jax_max_pool,
)
from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    FrozenBatchNorm2d,
    conv_bn_folded,
    max_pool_3x3_s2,
)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# f32: the same sums in another order. bf16: both sides round the conv
# output and the bias sum to bf16 (8 significant bits, 2^-9 relative each)
# after summing in another order; the bf16 stem sums by row parity in JAX.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


class _ConvBN(fnn.Module):
    features: int
    k: int
    stride: int
    padding: int
    dilation: int
    dtype: object

    @fnn.compact
    def __call__(self, x):
        return jax_conv_bn_folded(
            self, x, self.features, self.k, "conv", "bn", stride=self.stride,
            padding=self.padding, dilation=self.dilation, dtype=self.dtype)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cin,cout,k,stride,padding,dilation", [
    (3, 64, 7, 2, 3, 1),     # stem
    (64, 32, 1, 1, 0, 1),    # bottleneck 1x1
    (64, 32, 1, 2, 0, 1),    # strided reduce / downsample
    (32, 32, 3, 1, 2, 2),    # layer3 3x3
    (32, 32, 3, 1, 4, 4),    # layer4 3x3
])
def test_conv_bn_folded_matches_jax(rng, dtype, cin, cout, k, stride,
                                    padding, dilation):
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((1, 16, 24, cin)).astype(np.float32)
    mod = _ConvBN(cout, k, stride, padding, dilation, jdt)
    kernel = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.1
    bn = {"scale": rng.uniform(0.5, 1.5, cout), "bias": rng.standard_normal(cout) * 0.1}
    stats = {"mean": rng.standard_normal(cout), "var": rng.uniform(0.5, 2.0, cout)}
    bn = {k_: v.astype(np.float32) for k_, v in bn.items()}
    stats = {k_: v.astype(np.float32) for k_, v in stats.items()}
    variables = {"params": {"conv": {"conv": {"kernel": kernel}}, "bn": {"bn": bn}},
                 "batch_stats": {"bn": {"bn": stats}}}
    ref = np.asarray(mod.apply(variables, jnp.asarray(x, jdt)).astype(jnp.float32))

    conv = Conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation)
    fbn = FrozenBatchNorm2d(cout)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        fbn.weight.copy_(torch.from_numpy(bn["scale"]))
        fbn.bias.copy_(torch.from_numpy(bn["bias"]))
        fbn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        fbn.running_var.copy_(torch.from_numpy(stats["var"]))
        xt = _nchw(np.array(jnp.asarray(x, jdt).astype(jnp.float32))).to(tdt)
        out = conv_bn_folded(xt, conv, fbn, tdt)
    assert out.dtype == tdt
    ours = out.permute(0, 2, 3, 1).float().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 17, 24, 8), (2, 16, 15, 4)])
def test_max_pool_matches_jax(rng, dtype, shape):
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
    ref = np.asarray(jax_max_pool(x, False).astype(jnp.float32))
    xt = _nchw(np.array(x.astype(jnp.float32))).to(tdt)
    ours = max_pool_3x3_s2(xt).permute(0, 2, 3, 1).float().numpy()
    # A max selects one input: exact in either dtype.
    np.testing.assert_array_equal(ours, ref)
