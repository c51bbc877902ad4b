"""The port's Warper train steps against the JAX package's on the CPU, and a
CPU smoke of the train CLI in the fork's default mode.

Twin modules as in tests/test_torch_train_steps.py (a three-conv stride-8
segmenter and a narrow FCDiscriminator) plus a shallow real Warper
(num_layers 5, Batch norm) with the same weights on both sides, f32. On the
CPU the JAX steps warp through the unfused XLA composition
(adaptsegnet_tpu/ops/pallas/upsample_warp.py:771-780), the port through its
kernel's plain version: the same function summed in other orders. After
each of 2 steps the metrics agree within rtol 1e-4; after both, the G and D
parameters within rtol 1e-4 and atol 2e-6, the Warper's weights are exactly
their initial values on both sides and its BN running statistics agree
within rtol 1e-5 and atol 1e-6.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.models.warper import Warper as JaxWarper
from adaptsegnet_tpu.train.state import WarperState
from adaptsegnet_tpu.train.steps import (
    make_adversarial_step as jax_adversarial_step,
    make_source_only_step as jax_source_only_step,
)
from adaptsegnet_tpu_torch.models import Warper
from adaptsegnet_tpu_torch.train.steps import (
    make_adversarial_step,
    make_source_only_step,
)
from adaptsegnet_tpu_torch.utils import pth_interop
from tests.test_torch_train_steps import (
    C,
    JaxTinySeg,
    compare_params,
    twin_states,
)

HW = (32, 64)  # multiples of 2^5 for the 5-layer Warper
LAYERS = 5


def add_warper(jstate, state):
    jw = JaxWarper(num_layers=LAYERS, planar_flow=True)
    v = jax.device_get(jax.jit(jw.init)(jax.random.PRNGKey(21),
                                        jnp.zeros((1, *HW, 3))))
    jstate = jstate.replace(warper=WarperState(
        params=jax.tree.map(jnp.asarray, v["params"]),
        stats={"batch_stats": jax.tree.map(jnp.asarray, v["batch_stats"])}))
    state.warper = Warper(num_layers=LAYERS, device="cpu")
    assert pth_interop.load_into(state.warper,
                                 pth_interop.from_jax_variables(v)) == []
    return jw, jstate, {k: t.clone() for k, t in state.warper.state_dict().items()}


def make_batch(rng, iter_size):
    batch = {
        "images": rng.standard_normal((iter_size, 2, *HW, 3)).astype(np.float32),
        "labels": rng.integers(0, C, size=(iter_size, 2, *HW)),
        "target_images": rng.standard_normal((iter_size, 2, *HW, 3)).astype(np.float32),
    }
    batch["labels"][..., :3] = 255
    return batch


def compare_warper(jstate, state, initial):
    ref = pth_interop.from_jax_variables(jax.device_get(
        {"params": jstate.warper.params, **jstate.warper.stats}))
    moved = 0
    for k, v in state.warper.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            moved += int(not torch.equal(v, initial[k]))
        else:  # weights: never optimised
            assert torch.equal(v, initial[k]), k
            np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    # every BN's mean and var: encoder down1 .. down(L-2), decoder up0 .. up(L-2)
    assert moved == 2 * ((LAYERS - 2) + (LAYERS - 1))


def run_steps(rng, jstep, step, jstate, state, iter_size, keys):
    for _ in range(2):
        batch = {k: v for k, v in make_batch(rng, iter_size).items() if k in keys}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    return jstate


@pytest.mark.parametrize("iter_size", [1, 2])
def test_source_only_warper_step_matches_jax(rng, iter_size):
    _, jstate, state = twin_states(rng, with_d=False)
    jw, jstate, initial = add_warper(jstate, state)
    jstep = jax_source_only_step(JaxTinySeg(), warper_module=jw, input_hw=HW,
                                 iter_size=iter_size, donate=False)
    step = make_source_only_step(HW, iter_size)
    jstate = run_steps(rng, jstep, step, jstate, state, iter_size,
                       ("images", "labels"))
    compare_params(jstate, state)
    compare_warper(jstate, state, initial)
    assert all(not p.requires_grad or p.grad is None
               for p in state.warper.parameters())


@pytest.mark.parametrize("gan", ["LS", "Vanilla"])
def test_single_level_warper_step_matches_jax(rng, gan):
    """The source flow also warps the target prediction (the fork's
    quirk); the D reads softmax of the warped maps."""
    disc, jstate, state = twin_states(rng, multi=False)
    jw, jstate, initial = add_warper(jstate, state)
    jstep = jax_adversarial_step(JaxTinySeg(), disc, level="single-level",
                                 gan=gan, input_hw=HW, warper_module=jw,
                                 donate=False)
    step = make_adversarial_step(level="single-level", gan=gan, input_hw=HW)
    jstate = run_steps(rng, jstep, step, jstate, state, 1,
                       ("images", "labels", "target_images"))
    compare_params(jstate, state)
    compare_warper(jstate, state, initial)


def test_train_cli_default_mode_and_resume(tmp_path, capsys, monkeypatch):
    """`cli.train --cpu` with the default mode flags (source-only, the
    Warper with Batch norm; 6 layers so that a 64x64 input fits): 2 steps
    write GTA5_2.pth and the full state; a second run resumes it, with the
    Warper's running statistics, and stops at step 3."""
    from adaptsegnet_tpu_torch.cli import train as cli_train
    from adaptsegnet_tpu_torch.data import lists
    from adaptsegnet_tpu_torch.train.config import parse_args

    gta = lists.make_synthetic_gta5(str(tmp_path / "gta5"), n=3, size_wh=(64, 64))
    snap = str(tmp_path / "snap")
    argv = ["--cpu", "--data-dir", os.path.dirname(gta), "--data-list", gta,
            "--input-size", "64,64", "--warper-num-layers", "6",
            "--num-steps", "100", "--restore-from", "", "--snapshot-dir", snap,
            "--num-workers", "2"]
    cfg = parse_args(argv)
    assert cfg.source_only and cfg.warper and cfg.uses_warper
    assert cfg.warper_norm == "Batch"
    out = cli_train.main(argv + ["--num-steps-stop", "2"])
    assert out["steps"] == 2
    assert abs(out["final_metrics"]["loss_seg2"] - np.log(19)) < 0.05
    mode = os.path.join(snap, "source_only")
    assert "GTA5_2.pth" in os.listdir(mode)
    saved = torch.load(os.path.join(mode, "full_state", "state_2.pt"),
                       weights_only=False)
    stats = {k: v for k, v in saved["warper"].items() if k.endswith("running_var")}
    assert stats and all(not torch.all(v == 1) for v in stats.values())

    capsys.readouterr()
    restored = {}
    real_load = torch.nn.Module.load_state_dict

    def spy(self, sd, *a, **kw):
        restored.update(sd)
        return real_load(self, sd, *a, **kw)

    monkeypatch.setattr(Warper, "load_state_dict", spy)
    out = cli_train.main(argv + ["--num-steps-stop", "3"])
    printed = capsys.readouterr().out
    assert "resumed the full state at step 2" in printed
    assert printed.count("iter = ") == 1
    assert out["steps"] == 3
    for k, v in stats.items():
        assert torch.equal(restored[k], v)
