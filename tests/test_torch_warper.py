"""The port's Warper against the JAX package's on the CPU, f32.

Weights are drawn by flax and carried across with
utils/pth_interop.py::from_jax_variables; the BN scales, biases and running
statistics are perturbed first so that none of them is a no-op. Compared:
the planar flow in train mode (batch statistics) and in eval mode (running
statistics), and the state after one train call against flax's mutated
collections (BN running stats, which catches a running variance stored
unbiased as torch's BatchNorm2d stores it, and the spectral `u` vectors),
for all three norms and both decoder layouts. Tolerances: the flow within
rtol 1e-4 plus 1e-4 of its largest magnitude (a deep net of f32 convs
summed in other orders), the state within rtol 1e-5 plus 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.models.warper import Warper as JaxWarper
from adaptsegnet_tpu.ops.resize import (
    resize_bilinear_half_pixel as jax_resize_half_pixel,
)
from adaptsegnet_tpu.utils import pth_interop as jax_io
from adaptsegnet_tpu_torch.models import Warper
from adaptsegnet_tpu_torch.ops.resize import resize_bilinear_half_pixel
from adaptsegnet_tpu_torch.utils import pth_interop


def _perturb(variables, rng):
    """Random BN affine and running statistics (variance > 0)."""
    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            v = np.asarray(v)
            if coll == "batch_stats":
                v = (rng.uniform(0.5, 2.0, v.shape) if k == "var"
                     else rng.standard_normal(v.shape) * 0.1)
            elif k in ("scale", "bias") and v.ndim == 1 and coll == "params":
                v = v + rng.standard_normal(v.shape) * 0.1
            out[k] = np.asarray(v, np.float32)
        return out
    return {coll: walk(t, coll) for coll, t in variables.items()}


def _twins(rng, hw, **kw):
    jm = JaxWarper(planar_flow=True, **kw)
    v = _perturb(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(5),
                                                 jnp.zeros((1, *hw, 3)))), rng)
    model = Warper(device="cpu", **kw)
    assert pth_interop.load_into(model, pth_interop.from_jax_variables(v)) == []
    return jm, v, model


def _close(got, ref, rtol, atol_scale):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol_scale * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("norm,transpose,num_layers,hw", [
    ("Batch", False, 5, (32, 64)),
    ("Batch", True, 5, (32, 32)),
    ("Instance", False, 5, (32, 32)),
    ("Spectral", False, 5, (32, 32)),
    ("Spectral", True, 6, (64, 64)),
    ("Batch", False, 8, (256, 256)),  # the default depth at its least size
])
def test_warper_matches_flax(rng, norm, transpose, num_layers, hw):
    kw = dict(num_layers=num_layers, norm=norm, transpose=transpose)
    jm, v, model = _twins(rng, hw, **kw)
    n = 1 if num_layers == 8 else 2  # one 256x256 image: 2x2 at down6
    x = rng.standard_normal((n, *hw, 3)).astype(np.float32)
    mutable = [k for k in v if k != "params"]
    (jflow, jlist), mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=mutable))(v, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        flow, warp_list = model(torch.from_numpy(x))
    assert flow.shape == (n, 2, *hw) and flow.is_contiguous()
    assert len(warp_list) == len(jlist) == num_layers
    _close(flow, jflow, 1e-4, 1e-4)
    after = pth_interop.from_jax_variables({"params": v["params"], **mut})
    sd = model.state_dict()
    assert set(after) == set(sd)
    for k, ref in after.items():
        _close(sd[k], ref, 1e-5, 1e-6)

    if norm != "Batch":
        return  # eval mode differs from train mode only in the BN
    jeval, _ = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": v["params"], **mut}, jnp.asarray(x))
    model.eval()
    with torch.no_grad():
        flow_eval, _ = model(torch.from_numpy(x))
    _close(flow_eval, jeval, 1e-4, 1e-4)


def test_bn_running_stats_use_flax_law(rng):
    """One train call at down6 of a 256x256 input (2x2 pixels per channel,
    batch 2): the stored variance is the biased batch variance, momentum
    0.9 in flax's convention (unbiased would be 8/7 of it)."""
    from adaptsegnet_tpu_torch.models.layers import WarperBatchNorm2d

    bn = WarperBatchNorm2d(4)
    x = torch.from_numpy(rng.standard_normal((2, 4, 2, 2)).astype(np.float32))
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.1 * x.mean(dim=(0, 2, 3)).numpy(), rtol=1e-5,
                               atol=1e-7)
    bn.eval()
    before = bn.running_var.clone()
    bn(x)
    assert torch.equal(before, bn.running_var)


@pytest.mark.parametrize("in_hw,out_hw", [((4, 8), (8, 16)), ((5, 3), (10, 6)),
                                          ((4, 4), (4, 4))])
def test_half_pixel_resize_matches_jax(rng, in_hw, out_hw):
    """f32 exact against the JAX matrices; bf16 in-dtype within one bf16
    ulp plus 1e-2 of the largest value (two bf16 roundings on each side)."""
    x = rng.standard_normal((2, *in_hw, 5)).astype(np.float32)
    ref = np.asarray(jax_resize_half_pixel(jnp.asarray(x), out_hw))
    got = resize_bilinear_half_pixel(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    refb = np.asarray(jax_resize_half_pixel(
        jnp.asarray(x, jnp.bfloat16), out_hw, exact=False).astype(jnp.float32))
    gotb = resize_bilinear_half_pixel(torch.from_numpy(x).bfloat16(), out_hw,
                                      exact=False)
    assert gotb.dtype == torch.bfloat16
    err = np.abs(gotb.float().numpy() - refb)
    assert np.all(err <= 2.0 ** -7 * np.abs(refb) + 1e-2 * np.abs(refb).max())


@pytest.mark.parametrize("transpose", [False, True])
def test_reference_keys_round_trip(rng, tmp_path, transpose):
    """The port's Warper state dict has the reference's keys: saved as a
    .pth, it loads through the JAX package's reference-key loader
    (warper_state_dict_to_variables) into flax, whose flow then equals the
    port's, and back into a fresh port Warper through `warper_state_dict`
    (which drops the reference's never-called `connection.*` keys)."""
    kw = dict(num_layers=5, norm="Batch", transpose=transpose)
    model = Warper(device="cpu", generator=torch.Generator().manual_seed(3), **kw)
    path = str(tmp_path / "warper.pth")
    sd = dict(model.state_dict())
    sd["connection.container.0.input.weight"] = torch.zeros(2, 512, 1, 1)
    pth_interop.save_torch_state_dict(sd, path)

    jm = JaxWarper(planar_flow=True, **kw)
    base = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 32, 32, 3))))
    loaded = jax_io.warper_state_dict_to_variables(jax_io.load_torch_state_dict(path))
    variables = jax_io.merge_variables(base, loaded)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    jflow, _ = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x))

    fresh = Warper(device="cpu", generator=torch.Generator().manual_seed(4), **kw)
    assert pth_interop.load_into(fresh, pth_interop.warper_state_dict(
        pth_interop.load_torch_state_dict(path))) == []
    for m in (model, fresh):
        m.eval()
        with torch.no_grad():
            _close(m(torch.from_numpy(x))[0], jflow, 1e-4, 1e-4)


def test_init_law_and_sizes():
    """xavier-normal (gain 0.02) convs, BN weight ~ N(1, 0.02); sizes that
    are not multiples of 2^num_layers raise."""
    model = Warper(device="cpu", num_layers=8)
    w = model.encoder_d.down_list[3].block[1].l.weight  # 256 -> 512, 4x4
    std = 0.02 * np.sqrt(2.0 / (16 * 256 + 16 * 512))
    assert abs(w.std().item() / std - 1) < 0.02
    bn = model.decoder_d.up_list[0].block[2].norm.weight
    assert abs(bn.mean().item() - 1) < 0.01 and 0.015 < bn.std().item() < 0.025
    keys = set(model.state_dict())
    assert "encoder_d.down_list.0.input.weight" in keys
    assert "encoder_d.out.down.1.weight" in keys
    assert "decoder_d.up_list.7.output.2.bias" in keys
    for hw in ((128, 256), (256, 384)):
        with pytest.raises(ValueError, match="multiples of 256"):
            model(torch.zeros((1, *hw, 3)))
    with pytest.raises(ValueError, match="num_layers"):
        Warper(device="cpu", num_layers=4)


def test_dropout_uses_its_generator():
    """use_dropout: eval mode equals the model without dropout; train mode
    draws its masks from the given generator, so a reseeded generator
    repeats the flow."""
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    plain = Warper(device="cpu", num_layers=5)
    drop = Warper(device="cpu", num_layers=5, use_dropout=True,
                  dropout_generator=torch.Generator().manual_seed(7))
    drop.load_state_dict(plain.state_dict())
    plain.eval()
    drop.eval()
    with torch.no_grad():
        assert torch.equal(plain(x)[0], drop(x)[0])
        drop.train()
        state = {k: v.clone() for k, v in drop.state_dict().items()}
        a = drop(x)[0]
        drop.load_state_dict(state)
        drop.decoder_d.dropout_generator.manual_seed(7)
        b = drop(x)[0]
        drop.load_state_dict(state)
        plain.train()
        c = plain(x)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_warper_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Warper(num_layers=5)
