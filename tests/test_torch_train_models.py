"""Train-mode models of the port against the JAX package on the CPU: the
backbone's gradients through the BN fold, and the FCDiscriminator (forward,
gradients, state-dict layout, init law)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.models import FCDiscriminator as JaxFCDiscriminator
from adaptsegnet_tpu.models import ResNetBackbone as JaxResNetBackbone
from adaptsegnet_tpu.utils import pth_interop as jax_io
from adaptsegnet_tpu_torch.models import FCDiscriminator, ResNetBackbone
from adaptsegnet_tpu_torch.utils import pth_interop
from tests.test_torch_models import randomize_bn


def test_backbone_grads_match_jax(rng):
    """A cut ResNetBackbone (layers (1, 1, 2, 1)) in f32: the grads of a
    scalar loss with respect to every conv weight against jax.grad, with
    random frozen BN statistics (the fold is then not a no-op). The BN
    parameters are frozen on both sides. Tolerance rtol 1e-4 and 1e-4 of
    each tensor's largest magnitude."""
    layers = (1, 1, 2, 1)
    jmodel = JaxResNetBackbone(layers=layers)
    x = rng.standard_normal((1, 32, 48, 3)).astype(np.float32)
    variables = randomize_bn(
        jax.device_get(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))), rng)
    r4 = rng.standard_normal((1, 4, 6, 2048)).astype(np.float32)
    r3 = rng.standard_normal((1, 4, 6, 1024)).astype(np.float32)

    def loss(params):
        f = jmodel.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, jnp.asarray(x))
        return jnp.sum(f["layer4"] * r4) + jnp.sum(f["layer3"] * r3)

    grads = jax.grad(loss)(jax.tree.map(jnp.asarray, variables["params"]))
    ref = pth_interop.from_jax_variables({"params": jax.device_get(grads)})

    model = ResNetBackbone(layers=layers, device="cpu")
    assert pth_interop.load_into(
        model, pth_interop.from_jax_variables(variables)) == []
    feats = model(torch.from_numpy(x))
    out = ((feats["layer4"] * torch.from_numpy(r4)).sum()
           + (feats["layer3"] * torch.from_numpy(r3)).sum())
    out.backward()
    n = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None  # frozen BN
            continue
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=name)
        n += 1
    assert n == 1 + 5 * 3 + 4  # the stem, 5 blocks x 3 convs, 4 shortcuts


def _port_disc(variables, ndf):
    d = FCDiscriminator(ndf=ndf, device="cpu")
    assert pth_interop.load_into(d, pth_interop.from_jax_variables(variables)) == []
    return d


def test_discriminator_matches_flax(rng):
    """f32 forward, input grad and parameter grads against the flax module
    on the same weights (dense NHWC input there, the planar map here):
    rtol 1e-4 and 1e-4 of each tensor's largest magnitude."""
    ndf = 8
    x = rng.random((2, 64, 96, 19)).astype(np.float32)
    x /= x.sum(-1, keepdims=True)
    jd = JaxFCDiscriminator(num_classes=19, ndf=ndf)
    variables = jax.device_get(jd.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    g = rng.standard_normal((2, 2, 3, 1)).astype(np.float32)

    def loss(params, xx):
        return jnp.sum(jd.apply({"params": params}, xx) * g)

    y = jd.apply(variables, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, variables["params"]), jnp.asarray(x))

    d = _port_disc(variables, ndf)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    ty = d(tx)
    assert ty.shape == (2, 2, 3, 1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-4,
                               atol=1e-6)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(gx), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(gx)).max())
    ref = pth_interop.from_jax_variables({"params": jax.device_get(gp)})
    for name, p in d.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_discriminator_bf16_dispatch_matches_f32(rng):
    """At ndf 64 in bf16 the D runs kernel 4 for conv1 and kernel 5 for
    conv2..4 (their plain versions on the CPU); against the f32 module on
    the same weights: scores within 2e-2 of their largest magnitude."""
    d32 = FCDiscriminator(device="cpu", generator=torch.Generator().manual_seed(3))
    d16 = FCDiscriminator(dtype=torch.bfloat16, device="cpu")
    d16.load_state_dict(d32.state_dict())
    x = torch.softmax(torch.from_numpy(
        rng.standard_normal((1, 19, 64, 96)).astype(np.float32)), 1)
    y32 = d32(x)
    y16 = d16(x)
    assert y16.dtype == torch.bfloat16 and y16.shape == y32.shape
    err = (y16.float() - y32).abs().max() / y32.abs().max()
    assert err < 2e-2, err
    y16.float().sum().backward()
    assert all(p.grad is not None for p in d16.parameters())


def test_discriminator_state_dict_keys_and_interop(rng):
    """Keys are the reference's (conv1..conv4, classifier), OIHW weights;
    a JAX export loads, and the port's export equals it."""
    jd = JaxFCDiscriminator(num_classes=19, ndf=64)
    variables = jax.device_get(
        jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 19))))
    ref = jax_io.variables_to_discriminator_state_dict(variables)
    d = _port_disc(variables, 64)
    sd = d.state_dict()
    assert set(sd) == set(ref) == {
        f"{m}.{leaf}" for m in ("conv1", "conv2", "conv3", "conv4", "classifier")
        for leaf in ("weight", "bias")}
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert tuple(sd["conv1.weight"].shape) == (64, 19, 4, 4)
    assert tuple(sd["classifier.weight"].shape) == (1, 512, 4, 4)


def test_discriminator_init_law():
    """torch's Conv2d default: weights and biases uniform in +-1/sqrt(fan_in),
    fan_in = 16 * Cin; the sample std within 5 % of bound / sqrt(3)."""
    d = FCDiscriminator(device="cpu", generator=torch.Generator().manual_seed(7))
    for name in ("conv1", "conv2", "conv3", "conv4", "classifier"):
        conv = getattr(d, name)
        bound = 1.0 / np.sqrt(16 * conv.weight.shape[1])
        w = conv.weight.detach().numpy()
        assert np.abs(w).max() <= bound
        assert abs(w.std() / (bound / np.sqrt(3)) - 1) < 0.05, name
        assert np.abs(conv.bias.detach().numpy()).max() <= bound
