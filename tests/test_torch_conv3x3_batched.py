"""Kernel 3 of the port (the batched dilated 3x3 forward of the bf16 eval
path): its plain version against the JAX Pallas kernel
`conv3x3_dil_mxu_batched` in interpret mode and against the XLA conv, its
gate against the JAX gate, and the routing of the eval forward.

On the CPU the wrapper runs its plain version, the function the CUDA kernel
computes: exact products of the operands summed in f32, rounded once to the
input's dtype. Tolerances: f32 inputs rtol 1e-4 / atol 1e-4 (the JAX
test's, tests/test_conv3x3.py:165); bf16 outputs one bf16 ulp of the
reference (the two f32 sums may straddle a rounding boundary) plus 1e-3 of
the largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.ops.pallas import conv3x3_dil as jax_k
from adaptsegnet_tpu_torch.models import ResNetBackbone
from adaptsegnet_tpu_torch.ops import conv3x3 as ops_conv3x3
from adaptsegnet_tpu_torch.ops.kernels import (
    conv3x3_dil,
    conv3x3_dil_batched_fwd,
    launch_counts,
    reset_launch_counts,
)
from tests.test_torch_train_kernels import as_np, assert_bf16_close, bf16_values, tb

CASES = [(2, 2), (4, 4), (2, 1)]  # (nb, d) of tests/test_conv3x3.py:165


def xla_conv(x, k, d):
    return jax.lax.conv_general_dilated(
        x, k, (1, 1), ((d, d), (d, d)), rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)


@pytest.mark.parametrize("nb,d", CASES)
def test_batched_plain_matches_pallas_f32(rng, nb, d):
    x = rng.standard_normal((4, 16, 24, 128)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 128, 128)) * 0.05).astype(np.float32)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got = conv3x3_dil_batched_fwd(torch.from_numpy(x), w, d, nb)
    assert got.dtype == torch.float32 and got.shape == (4, 16, 24, 128)
    pallas = jax_k.conv3x3_dil_mxu_batched(jnp.asarray(x), jnp.asarray(k), d,
                                           interpret=True, nb=nb)
    for ref in (pallas, xla_conv(jnp.asarray(x), jnp.asarray(k), d)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nb,d", CASES)
def test_batched_plain_matches_pallas_bf16(rng, nb, d):
    x = bf16_values(rng, (4, 16, 24, 128))
    k = bf16_values(rng, (3, 3, 128, 128), 0.05)
    got = conv3x3_dil_batched_fwd(tb(x), tb(k.transpose(3, 2, 0, 1)), d, nb)
    assert got.dtype == torch.bfloat16
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    pallas = jax_k.conv3x3_dil_mxu_batched(xb, kb, d, interpret=True, nb=nb)
    assert_bf16_close(as_np(got), np.asarray(pallas.astype(jnp.float32)))
    assert_bf16_close(as_np(got), np.asarray(xla_conv(xb, kb, d)))


def test_batched_nb_default_and_errors(rng):
    """nb=None picks `pick_nb`; the result does not depend on nb; a batch
    that nb does not divide, or of one image, raises."""
    x = tb(bf16_values(rng, (6, 8, 8, 128)))
    w = tb(bf16_values(rng, (128, 128, 3, 3), 0.05))
    assert torch.equal(conv3x3_dil_batched_fwd(x, w, 2),
                       conv3x3_dil_batched_fwd(x, w, 2, nb=3))
    with pytest.raises(ValueError, match="groups of 4"):
        conv3x3_dil_batched_fwd(x, w, 2, nb=4)
    with pytest.raises(ValueError, match="a batch of 1"):
        conv3x3_dil_batched_fwd(x[:1], w, 2)


# (shape NHWC, cout, d, dtype name): shapes the JAX gate's TPU row-blocking
# terms admit (h % r == 0, h // r >= 2, the VMEM budget), so the two gates
# must agree on them, and the reasons to refuse that both gates share.
GATE_TABLE = [
    ((4, 16, 24, 128), 128, 2, "bfloat16"),
    ((2, 16, 24, 128), 256, 1, "bfloat16"),
    ((8, 16, 16, 256), 128, 4, "bfloat16"),
    ((6, 16, 24, 128), 128, 2, "bfloat16"),
    ((12, 16, 8, 128), 128, 1, "bfloat16"),
    ((16, 16, 8, 128), 128, 2, "bfloat16"),
    ((1, 16, 24, 128), 128, 2, "bfloat16"),   # a single image
    ((3, 16, 24, 128), 128, 2, "bfloat16"),   # no group of 8, 4 or 2
    ((4, 16, 24, 128), 128, 3, "bfloat16"),   # dilation
    ((4, 16, 24, 64), 128, 2, "bfloat16"),    # cin
    ((4, 16, 24, 128), 64, 2, "bfloat16"),    # cout
    ((4, 16, 24, 128), 128, 2, "float32"),    # dtype
]


@pytest.mark.parametrize("shape,cout,d,dtype", GATE_TABLE)
def test_gate_matches_jax_gate(monkeypatch, shape, cout, d, dtype):
    """`supported_batched` and `pick_nb` against the JAX gate and `_pick_nb`
    (with the backend check answered as on the TPU)."""
    monkeypatch.setattr(jax_k.jax, "default_backend", lambda: "tpu")
    x = jnp.zeros(shape, getattr(jnp, dtype))
    ours = conv3x3_dil.supported_batched(shape, cout, d, getattr(torch, dtype))
    assert ours == bool(jax_k.supported_batched(x, cout, d))
    n, h, w, cin = shape
    r = max(2 * d, 8)
    assert conv3x3_dil.pick_nb(n) == jax_k._pick_nb(n, h, w, cin, cout, d, r)


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(conv3x3_dil, name)

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(ops_conv3x3.conv3x3_dil, name, counted)
    return calls


def test_eval_routing(monkeypatch, rng):
    """Without autograd a bf16 batch of two sends the layer2 (d 1), layer3
    (d 2) and layer4 (d 4) 3x3 convs of a cut backbone to the batched
    wrapper: 2 + 2 + 1 calls for layers (1, 2, 2, 1), none for layer1 (64
    channels). One image, f32 and a recording forward call it zero times;
    the recording forward takes kernel 2's wrapper on layer3 and layer4."""
    batched = _count_calls(monkeypatch, "conv3x3_dil_batched_fwd")
    fwd = _count_calls(monkeypatch, "conv3x3_dil_fwd")
    x = torch.from_numpy(rng.standard_normal((2, 32, 48, 3)).astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(5)
    bf16 = ResNetBackbone(layers=(1, 2, 2, 1), dtype=torch.bfloat16,
                          device="cpu", generator=gen())
    reset_launch_counts()
    with torch.no_grad():
        ref = bf16(x)
    assert len(batched) == 5 and not fwd
    assert sorted(s[-1] for s in batched) == [128, 128, 256, 256, 512]
    with torch.inference_mode():
        again = bf16(x)
    assert len(batched) == 10
    assert torch.equal(ref["layer4"], again["layer4"])
    with torch.no_grad():
        bf16(x[:1])
    assert len(batched) == 10
    f32 = ResNetBackbone(layers=(1, 2, 2, 1), device="cpu", generator=gen())
    with torch.no_grad():
        f32(x)
    assert len(batched) == 10 and not fwd
    out = bf16(x)  # autograd records: kernel 2's path
    assert len(batched) == 10 and len(fwd) == 3
    # the two routes compute the same function of the same weights
    assert_bf16_close(as_np(out["layer4"].detach()), as_np(ref["layer4"]))
    assert not any(launch_counts().values())  # CPU tensors launch nothing
