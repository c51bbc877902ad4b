"""The port's ResNet backbone, ASPP head and DeeplabMulti vs the JAX
package's, on the same weights (carried across by from_jax_variables)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adaptsegnet_tpu.models import DeeplabMulti as JaxDeeplabMulti
from adaptsegnet_tpu.models import ResNetBackbone as JaxResNetBackbone
from adaptsegnet_tpu.ops.aspp import aspp_matmul
from adaptsegnet_tpu.utils import pth_interop as jax_io
from adaptsegnet_tpu_torch.models import DeeplabMulti, ResNetBackbone
from adaptsegnet_tpu_torch.ops.aspp import aspp_sum
from adaptsegnet_tpu_torch.utils import pth_interop


def randomize_bn(variables, rng):
    """Numpy copy of flax variables with every BN tensor randomised: at
    init (scale 1, bias 0, mean 0, var 1) the fold is a no-op and the
    logits nearly vanish. Ranges of tests/test_models.py."""
    draw = {
        "var": lambda s: rng.uniform(0.5, 2.0, s),
        "mean": lambda s: rng.standard_normal(s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.standard_normal(s) * 0.1,
    }

    def rec(node, parent):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = rec(v, k)
            elif parent == "bn":
                out[k] = draw[k](v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    return {coll: rec(tree, None) for coll, tree in variables.items()}


def port_model(cls, variables, **kw):
    model = cls(device="cpu", **kw)
    missing = pth_interop.load_into(
        model, pth_interop.from_jax_variables(variables))
    assert missing == []
    return model


@pytest.fixture(scope="module")
def multi():
    model = JaxDeeplabMulti(num_classes=19)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 96, 3)))
    variables = randomize_bn(jax.device_get(variables),
                             np.random.default_rng(7))
    return model, variables


def test_backbone_cut_matches_jax(rng):
    layers = (1, 1, 2, 1)
    jmodel = JaxResNetBackbone(layers=layers)
    x = rng.standard_normal((1, 64, 96, 3)).astype(np.float32)
    variables = randomize_bn(
        jax.device_get(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))),
        rng)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    model = port_model(ResNetBackbone, variables, layers=layers)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    for name in ("layer1", "layer2", "layer3", "layer4"):
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n_sum", [2, 4])
def test_aspp_matches_aspp_matmul(rng, n_sum):
    dils = (6, 12, 18, 24)
    x = rng.standard_normal((1, 16, 20, 32)).astype(np.float32)
    kernels = [rng.standard_normal((3, 3, 32, 19)).astype(np.float32) * 0.1
               for _ in dils]
    biases = [rng.standard_normal(19).astype(np.float32) for _ in dils]
    ref = aspp_matmul(jnp.asarray(x), [jnp.asarray(k) for k in kernels],
                      [jnp.asarray(b) for b in biases], dils, n_sum)
    ours = aspp_sum(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in kernels],
        [torch.from_numpy(b) for b in biases], dils, n_sum)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels", [32, 256])
def test_aspp_bf16_matches_aspp_matmul(rng, channels):
    """bf16: products and the branch sum in f32, one cast at the end, so
    the two packages differ only in f32 summation order. Tolerance: one
    bf16 ulp of the reference, plus 1e-4 for that order near zero. Branch
    outputs rounded to bf16 before the sum miss it by up to 0.06."""
    dils = (6, 12, 18, 24)
    x = rng.standard_normal((1, 16, 20, channels)).astype(np.float32)
    kernels = [rng.standard_normal((3, 3, channels, 19)).astype(np.float32) * 0.1
               for _ in dils]
    biases = [rng.standard_normal(19).astype(np.float32) for _ in dils]
    ref = aspp_matmul(jnp.asarray(x, jnp.bfloat16),
                      [jnp.asarray(k) for k in kernels],
                      [jnp.asarray(b) for b in biases], dils)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = aspp_sum(
        torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16),
        [torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) for k in kernels],
        [torch.from_numpy(b) for b in biases], dils)
    assert ours.dtype == torch.bfloat16
    ours = ours.permute(0, 2, 3, 1).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(ours - ref) <= ulp + 1e-4)


def test_deeplab_multi_matches_jax(rng, multi):
    jmodel, variables = multi
    x = rng.standard_normal((1, 64, 96, 3)).astype(np.float32)
    r1, r2 = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    model = port_model(DeeplabMulti, variables)
    with torch.no_grad():
        p1, p2 = model(torch.from_numpy(x))
    assert p1.shape == p2.shape == (1, 8, 12, 19)
    # The tolerance of tests/test_models.py's oracle comparison.
    np.testing.assert_allclose(p1.numpy(), np.asarray(r1), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(p2.numpy(), np.asarray(r2), rtol=1e-3, atol=1e-4)


def test_deeplab_multi_param_count():
    model = DeeplabMulti(device="cpu")
    backbone = sum(p.numel() for n, p in model.named_parameters()
                   if not n.startswith(("layer5.", "layer6.")))
    assert backbone == 42_500_160
    assert sum(p.numel() for p in model.layer5.parameters()) == 4 * (3 * 3 * 1024 * 19 + 19)
    assert sum(p.numel() for p in model.layer6.parameters()) == 4 * (3 * 3 * 2048 * 19 + 19)


def test_from_jax_variables_matches_export(multi):
    _, variables = multi
    ours = pth_interop.from_jax_variables(variables)
    ref = {k: v for k, v in jax_io.variables_to_resnet_state_dict(variables).items()
           if not k.endswith("num_batches_tracked")}
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    # The port's module keys are the reference's torch keys.
    assert set(DeeplabMulti(device="cpu").state_dict()) == set(ref)


def test_pth_roundtrip(tmp_path, multi):
    _, variables = multi
    model = port_model(DeeplabMulti, variables)
    path = str(tmp_path / "snap.pth")
    pth_interop.save_torch_state_dict(model.state_dict(), path)
    fresh = DeeplabMulti(device="cpu", generator=torch.Generator().manual_seed(5))
    assert pth_interop.load_into(fresh, pth_interop.load_torch_state_dict(path)) == []
    for (k, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    # A snapshot written by the JAX package, DataParallel-prefixed, loads too.
    sd = {"module." + k: v
          for k, v in jax_io.variables_to_resnet_state_dict(variables).items()}
    jax_io.save_torch_state_dict(sd, path)
    loaded = pth_interop.load_torch_state_dict(path)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)
