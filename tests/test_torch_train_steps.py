"""The port's train steps against the JAX package's on twin tiny modules,
and a CPU smoke of the train CLI with the full DeeplabMulti.

Twin modules (like tests/test_steps.py:34-52): a three-conv stride-8
segmenter with `layer5` / `layer6` heads, and the real FCDiscriminator at a
small width, with the same weights carried across. The JAX steps run their
jitted programs, the port's steps eager autograd; both in f32 on the CPU.
After each of 2 steps the metrics agree within rtol 1e-4, and after both
the parameters within rtol 1e-4 and atol 2e-6 (Adam's first updates are
lr * g / (|g| + eps), so a gradient near 0 moves its parameter by up to
lr in either framework).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from adaptsegnet_tpu.models import FCDiscriminator as JaxFCDiscriminator
from adaptsegnet_tpu.models.layers import Conv2d as JaxConv2d
from adaptsegnet_tpu.train.optim import (
    generator_param_labels,
    make_discriminator_tx,
    make_generator_tx,
)
from adaptsegnet_tpu.train.state import (
    DiscriminatorState,
    GeneratorState,
    TrainState as JaxTrainState,
)
from adaptsegnet_tpu.train.steps import (
    make_adversarial_step as jax_adversarial_step,
    make_source_only_step as jax_source_only_step,
)
from adaptsegnet_tpu_torch.models import DeeplabMulti, FCDiscriminator
from adaptsegnet_tpu_torch.train.optim import (
    make_discriminator_optimizer,
    make_generator_optimizer,
)
from adaptsegnet_tpu_torch.train.state import Schedule, TrainState
from adaptsegnet_tpu_torch.train.steps import (
    make_adversarial_step,
    make_source_only_step,
)
from adaptsegnet_tpu_torch.utils import pth_interop

C = 19
HW = (32, 48)
NDF = 4
LR, LR_D, STEPS = 0.01, 1e-4, 100
_SEG = (("stem", 3, 8, 3, 2), ("mid", 8, 8, 3, 2), ("down", 8, 8, 3, 2),
        ("layer5", 8, C, 1, 1), ("layer6", 8, C, 1, 1))


class JaxTinySeg(nn.Module):
    @nn.compact
    def __call__(self, x):
        h = nn.relu(JaxConv2d(8, 3, stride=2, padding=1, name="stem")(x))
        h = nn.relu(JaxConv2d(8, 3, stride=2, padding=1, name="mid")(h))
        h = JaxConv2d(8, 3, stride=2, padding=1, name="down")(h)
        return (JaxConv2d(C, 1, name="layer5")(h),
                JaxConv2d(C, 1, name="layer6")(h))


class TinySeg(torch.nn.Module):
    """The port-side twin: NHWC in, (pred1, pred2) NHWC raw logits out."""

    dtype = torch.float32

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, _ in _SEG:
            setattr(self, name, torch.nn.Conv2d(cin, cout, k, padding=k // 2))

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        h = F.relu(F.conv2d(h, self.stem.weight, self.stem.bias, 2, 1))
        h = F.relu(F.conv2d(h, self.mid.weight, self.mid.bias, 2, 1))
        h = F.conv2d(h, self.down.weight, self.down.bias, 2, 1)
        return tuple(head(h).permute(0, 2, 3, 1) for head in (self.layer5, self.layer6))


def twin_states(rng, multi=True, with_d=True):
    seg_params = {
        name: {"conv": {
            "kernel": (rng.standard_normal((k, k, cin, cout)) * 0.3).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)}}
        for name, cin, cout, k, _ in _SEG}
    jparams = jax.tree.map(jnp.asarray, seg_params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        generator=GeneratorState.create(
            jparams, {}, make_generator_tx(generator_param_labels(jparams),
                                           base_lr=LR, num_steps=STEPS)))
    tiny = TinySeg()
    with torch.no_grad():
        for name, *_ in _SEG:
            conv = getattr(tiny, name)
            conv.weight.copy_(torch.from_numpy(
                seg_params[name]["conv"]["kernel"].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(seg_params[name]["conv"]["bias"]))
    state = TrainState(model=tiny, g_opt=make_generator_optimizer(tiny, LR),
                       schedule=Schedule(LR, LR_D, STEPS))
    disc = JaxFCDiscriminator(num_classes=C, ndf=NDF)
    if with_d:
        jd = {}
        for i, key in ((1, 11), (2, 12)):
            if i == 1 and not multi:
                continue
            v = jax.device_get(disc.init(jax.random.PRNGKey(key),
                                         jnp.zeros((1,) + HW + (C,))))
            jd[i] = DiscriminatorState.create(
                jax.tree.map(jnp.asarray, v["params"]),
                make_discriminator_tx(base_lr=LR_D, num_steps=STEPS))
            d = FCDiscriminator(num_classes=C, ndf=NDF, device="cpu")
            assert pth_interop.load_into(d, pth_interop.from_jax_variables(v)) == []
            setattr(state, f"d{i}", d)
            setattr(state, f"d{i}_opt", make_discriminator_optimizer(d, LR_D))
        jstate = jstate.replace(d1=jd.get(1), d2=jd[2])
    return disc, jstate, state


def make_batch(rng, iter_size):
    batch = {
        "images": rng.standard_normal((iter_size, 2, *HW, 3)).astype(np.float32),
        "labels": rng.integers(0, C, size=(iter_size, 2, *HW)),
        "target_images": rng.standard_normal((iter_size, 2, *HW, 3)).astype(np.float32),
    }
    batch["labels"][..., :3] = 255
    return batch


def compare_params(jstate, state):
    seg = jstate.generator.params
    for name, *_ in _SEG:
        conv = getattr(state.model, name)
        for leaf, ours in (("kernel", conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
                           ("bias", conv.bias.detach().numpy())):
            np.testing.assert_allclose(ours, np.asarray(seg[name]["conv"][leaf]),
                                       rtol=1e-4, atol=2e-6, err_msg=name)
    for i in (1, 2):
        jd, d = getattr(jstate, f"d{i}"), getattr(state, f"d{i}")
        if jd is None:
            continue
        ref = pth_interop.from_jax_variables({"params": jax.device_get(jd.params)})
        for k, v in d.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=f"D{i} {k}")


@pytest.mark.parametrize("level,gan,iter_size", [
    ("multi-level", "LS", 1), ("multi-level", "Vanilla", 1),
    ("single-level", "LS", 1), ("single-level", "Vanilla", 2),
    ("multi-level", "LS", 2)])
def test_adversarial_step_matches_jax(rng, level, gan, iter_size):
    multi = level == "multi-level"
    disc, jstate, state = twin_states(rng, multi=multi)
    jstep = jax_adversarial_step(JaxTinySeg(), disc, level=level, gan=gan,
                                 input_hw=HW, iter_size=iter_size, donate=False)
    step = make_adversarial_step(level=level, gan=gan, input_hw=HW,
                                 iter_size=iter_size)
    for _ in range(2):
        batch = make_batch(rng, iter_size)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    assert state.step == int(jstate.step) == 2
    compare_params(jstate, state)


@pytest.mark.parametrize("iter_size", [1, 2])
def test_source_only_step_matches_jax(rng, iter_size):
    _, jstate, state = twin_states(rng, with_d=False)
    jstep = jax_source_only_step(JaxTinySeg(), input_hw=HW,
                                 iter_size=iter_size, donate=False)
    step = make_source_only_step(HW, iter_size)
    for _ in range(2):
        batch = make_batch(rng, iter_size)
        del batch["target_images"]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss_seg2"].item(), float(jm["loss_seg2"]),
                                   rtol=1e-4)
    compare_params(jstate, state)


def test_train_cli_smoke_and_resume(tmp_path, capsys):
    """`cli.train --cpu` multi-level with the full DeeplabMulti at a tiny
    input on synthetic data: 2 steps write GTA5_2.pth + _D1/_D2 that load
    back into the port's modules; a second run resumes the full state and
    stops at step 3."""
    from adaptsegnet_tpu_torch.cli import train as cli_train
    from adaptsegnet_tpu_torch.data import lists

    gta = lists.make_synthetic_gta5(str(tmp_path / "gta5"), n=3, size_wh=(64, 64))
    cs = lists.make_synthetic_cityscapes(str(tmp_path / "cs"), "train", n=3,
                                         size_wh=(64, 64))
    snap = str(tmp_path / "snap")
    argv = ["--cpu", "--no-warper", "--no-source-only", "--level", "multi-level",
            "--data-dir", os.path.dirname(gta), "--data-list", gta,
            "--data-dir-target", os.path.dirname(cs), "--data-list-target", cs,
            "--input-size", "64,64", "--input-size-target", "64,64",
            "--num-steps", "100", "--restore-from", "", "--snapshot-dir", snap,
            "--num-workers", "2"]
    out = cli_train.main(argv + ["--num-steps-stop", "2"])
    assert out["steps"] == 2
    assert abs(out["final_metrics"]["loss_seg2"] - np.log(19)) < 0.05
    assert all(np.isfinite(v) for v in out["final_metrics"].values())
    mode = os.path.join(snap, "multi_level")
    assert {"GTA5_2.pth", "GTA5_2_D1.pth", "GTA5_2_D2.pth"} <= set(os.listdir(mode))
    model = DeeplabMulti(device="cpu", generator=torch.Generator().manual_seed(9))
    assert pth_interop.load_into(model, pth_interop.load_torch_state_dict(
        os.path.join(mode, "GTA5_2.pth"))) == []
    for tag in ("D1", "D2"):
        d = FCDiscriminator(device="cpu")
        assert pth_interop.load_into(d, pth_interop.load_torch_state_dict(
            os.path.join(mode, f"GTA5_2_{tag}.pth"))) == []

    capsys.readouterr()
    out = cli_train.main(argv + ["--num-steps-stop", "3"])
    printed = capsys.readouterr().out
    assert "resumed the full state at step 2" in printed
    assert printed.count("iter = ") == 1  # one step run: step 2
    assert out["steps"] == 3 and out["snapshots"] == [os.path.join(mode, "GTA5_3.pth")]
