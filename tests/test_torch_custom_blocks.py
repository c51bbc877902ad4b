"""The custom-layer zoo's remaining blocks against their flax counterparts
(adaptsegnet_tpu/models/custom_blocks.py), on the same weights carried
across by `from_jax_variables`: pixel_shuffle, PReLU, OneOneConvolution,
Connection, AdvancedDecoderOutput, and the Down / Keep discriminator
blocks in Batch and Spectral norm. Train mode (the live BN's batch
statistics, one power iteration of the spectral norm); outputs at rtol
1e-4 / atol 1e-5 of f32, and the mutated state (BN running statistics,
spectral `u`) at rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.models import custom_blocks as J
from adaptsegnet_tpu_torch.models import custom_blocks as P
from adaptsegnet_tpu_torch.utils import pth_interop

CIN = 16


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


BLOCKS = {
    # name: (flax module, port module, mutable collections, input shape)
    "PReLU": (lambda: J.PReLU(), lambda: P.PReLU(), (), (2, 8, 8, CIN)),
    "OneOneConvolution": (lambda: J.OneOneConvolution(4),
                          lambda: P.OneOneConvolution(CIN, 4, device="cpu"),
                          (), (2, 8, 8, CIN)),
    "AdvancedDecoderOutput": (
        lambda: J.AdvancedDecoderOutput(out_ch=3),
        lambda: P.AdvancedDecoderOutput(CIN, 3, device="cpu"),
        ("batch_stats",), (2, 8, 8, CIN)),
    "Down/Batch": (lambda: J.DownDiscriminatorBlock(8),
                   lambda: P.DownDiscriminatorBlock(CIN, 8, device="cpu"),
                   ("batch_stats",), (2, 16, 16, CIN)),
    "Down/Spectral": (
        lambda: J.DownDiscriminatorBlock(8, norm="Spectral"),
        lambda: P.DownDiscriminatorBlock(CIN, 8, "Spectral", device="cpu"),
        ("spectral",), (2, 16, 16, CIN)),
    "Keep/Batch": (lambda: J.KeepDiscriminatorBlock(8),
                   lambda: P.KeepDiscriminatorBlock(CIN, 8, device="cpu"),
                   ("batch_stats",), (2, 16, 16, CIN)),
    "Keep/Spectral": (
        lambda: J.KeepDiscriminatorBlock(8, norm="Spectral"),
        lambda: P.KeepDiscriminatorBlock(CIN, 8, "Spectral", device="cpu"),
        ("spectral",), (2, 16, 16, CIN)),
}


def _perturb(variables, rng):
    """Non-trivial BN affine and PReLU slopes (init: 1 / 0 / 0.25)."""
    def rec(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = rec(v, path + (k,))
            elif k == "alpha" or (k in ("scale", "bias") and "bn" in path):
                out[k] = (np.asarray(v) + rng.uniform(-0.3, 0.3, v.shape)
                          ).astype(np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out
    return rec(variables, ())


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(rng, name):
    make_j, make_p, mutable, shape = BLOCKS[name]
    x = rng.standard_normal(shape).astype(np.float32)
    jm = make_j()
    variables = _perturb(jax.device_get(jm.init(jax.random.PRNGKey(1),
                                                jnp.asarray(x))), rng)
    pm = make_p()
    assert pth_interop.load_into(pm, pth_interop.from_jax_variables(variables)) == []
    assert set(pth_interop.from_jax_variables(variables)) == set(pm.state_dict())
    if mutable:
        ref, mut = jm.apply(variables, jnp.asarray(x), mutable=list(mutable))
    else:
        ref, mut = jm.apply(variables, jnp.asarray(x)), {}
    pm.train()
    ours = pm(_nchw(x)) if name == "PReLU" else pm(_nchw(x), torch.float32)
    np.testing.assert_allclose(_nhwc(ours), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    if mut:
        moved = pth_interop.from_jax_variables(
            {**variables, **jax.device_get(mut)})
        sd = pm.state_dict()
        for k, v in moved.items():
            if k.endswith(("running_mean", "running_var", ".u")):
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


def test_pixel_shuffle_matches_flax(rng):
    x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    ref = np.asarray(J.pixel_shuffle(jnp.asarray(x), 2))
    ours = P.pixel_shuffle(_nchw(x), 2)
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(ours), ref)


def test_connection_matches_flax(rng):
    """Projection i maps warp_list[i + 1]; the last map passes through."""
    warp_list = [rng.standard_normal((1, 4, 4, 512)).astype(np.float32)
                 for _ in range(4)]
    jm = J.Connection(num_layers=5, warp_channels=2)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(2),
                                       [jnp.asarray(w) for w in warp_list]))
    pm = P.Connection(num_layers=5, warp_channels=2, device="cpu")
    assert pth_interop.load_into(pm, pth_interop.from_jax_variables(variables)) == []
    assert "container.0.one_one.1.weight" in pm.state_dict()
    ref = jm.apply(variables, [jnp.asarray(w) for w in warp_list])
    ours = pm([_nchw(w) for w in warp_list])
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_blocks_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: P.OneOneConvolution(4, 4),
                 lambda: P.DownDiscriminatorBlock(4, 4),
                 lambda: P.AdvancedDecoderOutput(4, 3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
