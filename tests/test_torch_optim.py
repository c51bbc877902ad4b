"""The port's optimizers, LR schedule and train config against the JAX
package's (optax chains, lr_poly, TrainConfig)."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.train import config as jax_config
from adaptsegnet_tpu.train.optim import (
    generator_param_labels,
    make_discriminator_tx,
    make_generator_tx,
)
from adaptsegnet_tpu.train.schedule import lr_poly as jax_lr_poly
from adaptsegnet_tpu_torch.train import config
from adaptsegnet_tpu_torch.train.optim import (
    generator_param_groups,
    make_discriminator_optimizer,
    make_generator_optimizer,
    set_poly_lr,
)
from adaptsegnet_tpu_torch.train.schedule import lr_poly


@pytest.mark.parametrize("step", [0, 1, 17, 99, 100, 150])
def test_lr_poly_matches_jax(step):
    np.testing.assert_allclose(lr_poly(2.5e-4, step, 100, 0.9),
                               float(jax_lr_poly(2.5e-4, step, 100, 0.9)),
                               rtol=1e-6, atol=0)


class _Net(torch.nn.Module):
    """Backbone-like and head-like parameters, plus a frozen one."""

    def __init__(self, rng):
        super().__init__()
        mk = lambda *s: torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)))
        self.conv1 = torch.nn.ParameterDict({"weight": mk(4, 3)})
        self.bn1 = torch.nn.ParameterDict({"weight": mk(4)})
        self.bn1["weight"].requires_grad_(False)
        self.layer5 = torch.nn.ParameterDict({"weight": mk(5, 4), "bias": mk(5)})


def test_generator_groups_exclude_frozen(rng):
    groups = generator_param_groups(_Net(rng))
    assert [g["lr_mult"] for g in groups] == [1.0, 10.0]
    assert [len(g["params"]) for g in groups] == [1, 2]


def test_sgd_groups_match_optax(rng):
    """Five SGD steps (momentum 0.9, coupled weight decay 5e-4, poly lr at
    the step count, heads at 10x, frozen params untouched) against
    make_generator_tx on the same gradients: rtol 1e-5."""
    net = _Net(rng)
    params = {"conv1": {"weight": net.conv1["weight"].detach().numpy().copy()},
              "bn1": {"bn": {"weight": net.bn1["weight"].detach().numpy().copy()}},
              "layer5": {"weight": net.layer5["weight"].detach().numpy().copy(),
                         "bias": net.layer5["bias"].detach().numpy().copy()}}
    labels = generator_param_labels(params)
    tx = make_generator_tx(labels, base_lr=0.01, num_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    opt = make_generator_optimizer(net, base_lr=0.01)
    torch_params = {("conv1", "weight"): net.conv1["weight"],
                    ("layer5", "weight"): net.layer5["weight"],
                    ("layer5", "bias"): net.layer5["bias"]}
    for step in range(5):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), jp)
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for (m, leaf), p in torch_params.items():
            p.grad = torch.from_numpy(np.asarray(grads[m][leaf]).copy())
        set_poly_lr(opt, 0.01, step, 10)
        opt.step()
    for (m, leaf), p in torch_params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[m][leaf]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(net.bn1["weight"].detach().numpy(),
                                  params["bn1"]["bn"]["weight"])


def test_adam_matches_optax(rng):
    """Five Adam(0.9, 0.99, eps 1e-8) steps at the poly lr against
    make_discriminator_tx: rtol 1e-5."""
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    tx = make_discriminator_tx(base_lr=1e-3, num_steps=10)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    lin = torch.nn.Linear(5, 6, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p0))
    opt = make_discriminator_optimizer(lin, base_lr=1e-3)
    for step in range(5):
        g = rng.standard_normal(p0.shape).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        lin.weight.grad = torch.from_numpy(g)
        set_poly_lr(opt, 1e-3, step, 10)
        opt.step()
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=1e-7)


def test_config_defaults_match_jax():
    """Every TrainConfig field of the JAX package exists in the port with
    the same default, and the parsers agree on no flags and on a few.
    Deviations: none (--orbax-checkpoints keeps its name and saves with
    torch.save)."""
    ours = {f.name: f.default for f in dataclasses.fields(config.TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_config.TrainConfig)}
    assert ours == ref
    for argv in ([], ["--no-warper", "--no-source-only", "--level",
                      "multi-level", "--compute-dtype", "bfloat16",
                      "--input-size", "64,32", "--iter-size", "2"]):
        assert (dataclasses.asdict(config.parse_args(argv))
                == dataclasses.asdict(jax_config.parse_args(argv)))


@pytest.mark.parametrize("argv", [
    ["--num-devices", "4"],  # the default mode (the Warper)
    ["--no-warper", "--num-devices", "4"],
    ["--no-warper", "--num-devices", "2"],
    ["--no-warper", "--num-devices", "8", "--bn-mode", "batch"],
    ["--no-warper", "--num-devices", "-1"],
    ["--no-source-only", "--level", "multi-level", "--num-devices", "4"],
    ["--model", "DeeplabVGG", "--no-source-only", "--num-devices", "2"],
])
def test_unported_flags_raise(argv, monkeypatch, caplog):
    """--num-devices is ported: `check_supported` passes these argument
    sets, and the world size they ask for is JAX's mesh size,
    `auto_mesh_size`, with 1, 2, 4 or 8 devices (a simulated
    `jax.devices()`) at global batches of 1 to 8, each warning about idle
    devices exactly when JAX's does."""
    from adaptsegnet_tpu.parallel import mesh as jax_mesh
    from adaptsegnet_tpu_torch.parallel import group

    config.check_supported(config.parse_args(argv))
    for available in (1, 2, 4, 8):
        monkeypatch.setattr(jax_mesh.jax, "devices",
                            lambda n=available: [object()] * n)
        for batch in (1, 2, 3, 4, 6, 8):
            cfg = config.parse_args([*argv, "--batch-size", str(batch)])
            caplog.clear()
            ref = jax_mesh.auto_mesh_size(cfg.batch_size, cfg.num_devices)
            ref_warned = len(caplog.records)
            caplog.clear()
            ours = group.auto_world_size(cfg.batch_size, cfg.num_devices,
                                         available)
            assert ours == ref, (argv, available, batch)
            assert len(caplog.records) == ref_warned, (argv, available, batch)
            if cfg.batch_size % ours == 0:
                config.check_supported(cfg)


def test_ported_modes_pass_the_check():
    for argv in ([], ["--no-source-only"],  # the Warper modes
                 ["--no-warper"], ["--no-warper", "--no-source-only"],
                 ["--no-source-only", "--level", "multi-level"],
                 ["--no-warper", "--num-devices", "1"],
                 ["--bn-mode", "batch"], ["--no-warper", "--optim-dup-quirk"],
                 ["--no-warper", "--source", "Synscapes"],
                 ["--model", "DeeplabVGG", "--no-source-only"],
                 ["--no-warper", "--tensorboard"],
                 # data parallelism (the world size comes from the launch)
                 ["--num-devices", "4"], ["--no-warper", "--num-devices", "2"],
                 ["--no-warper", "--num-devices", "8", "--bn-mode", "batch"],
                 ["--no-warper", "--num-devices", "0", "--batch-size", "4"],
                 ["--no-source-only", "--level", "multi-level",
                  "--num-devices", "4", "--batch-size", "8"],
                 ["--model", "DeeplabVGG", "--no-source-only",
                  "--num-devices", "2", "--batch-size", "2"]):
        config.check_supported(config.parse_args(argv))
