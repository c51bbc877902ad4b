"""The remaining train flags of the port against the JAX package:
train-mode BN with frozen affine (--bn-mode batch), the k-fold
duplicated SGD (--optim-dup-quirk), the VGG segmenter in the single-level
step (--model DeeplabVGG), the Synscapes source (--source Synscapes), the
tensorboard writer (--tensorboard) and a batch of two (--batch-size 2).
The CLI runs with each flag are in tests/test_torch_train_cli_flags.py.

Tolerances: BN forward and running statistics rtol 1e-5, its gradients rtol
1e-4; train steps over 2 steps rtol 1e-4 / atol 2e-6 (as
tests/test_torch_train_steps.py); SGD against the optax chain over 5 steps
rtol 1e-5.
"""

import collections
import os
import os.path as osp
import sys
import types

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import jax
import jax.numpy as jnp
from flax import linen as nn

from adaptsegnet_tpu.data import SynscapesDataset as JaxSynscapesDataset
from adaptsegnet_tpu.models import DeeplabMulti as JaxDeeplabMulti
from adaptsegnet_tpu.models import FCDiscriminator as JaxFCDiscriminator
from adaptsegnet_tpu.models import ResNetBackbone as JaxResNetBackbone
from adaptsegnet_tpu.models.layers import Conv2d as JaxConv2d
from adaptsegnet_tpu.models.layers import _BNTrainFrozenAffine
from adaptsegnet_tpu.models.layers import conv_bn_folded as jax_conv_bn_folded
from adaptsegnet_tpu.train import build as jax_build
from adaptsegnet_tpu.train.optim import (
    generator_param_labels,
    generator_param_multiplicity as jax_param_multiplicity,
    make_discriminator_tx,
    make_generator_tx,
)
from adaptsegnet_tpu.train.state import (
    DiscriminatorState,
    GeneratorState,
    TrainState as JaxTrainState,
)
from adaptsegnet_tpu.train.steps import make_adversarial_step as jax_adversarial_step
from adaptsegnet_tpu_torch.data import SynscapesDataset
from adaptsegnet_tpu_torch.models import (
    DeeplabMulti,
    DeeplabVGG,
    FCDiscriminator,
    ResNetBackbone,
)
from adaptsegnet_tpu_torch.models.layers import (
    Conv2d,
    FrozenBatchNorm2d,
    bn_train_frozen_affine,
    conv_bn_folded,
)
from adaptsegnet_tpu_torch.train import build
from adaptsegnet_tpu_torch.train.optim import (
    KFoldSGD,
    generator_param_multiplicity,
    make_discriminator_optimizer,
    make_generator_optimizer,
    set_poly_lr,
)
from adaptsegnet_tpu_torch.train.state import Schedule, TrainState
from adaptsegnet_tpu_torch.train.steps import make_adversarial_step
from adaptsegnet_tpu_torch.utils import pth_interop
from adaptsegnet_tpu_torch.utils.logging import ScalarLogger
from tests.test_torch_models import port_model, randomize_bn

C = 19
HW = (32, 48)
NDF = 4
LR, LR_D, STEPS = 0.01, 1e-4, 100


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), jax.device_get(tree))


# ------------------------------------------------------- --bn-mode batch


def test_bn_train_frozen_affine_matches_jax(rng):
    """Forward, the gradient through the batch statistics, and the running
    statistics (torch momentum 0.1, unbiased variance) against
    `_BNTrainFrozenAffine`; the affine gets no gradient."""
    c = 6
    y = (rng.standard_normal((2, 5, 7, c)) * 3 + 1.5).astype(np.float32)
    g = rng.standard_normal(y.shape).astype(np.float32)
    jbn = _BNTrainFrozenAffine(c)
    variables = _np_tree(jbn.init(jax.random.PRNGKey(0), jnp.asarray(y)))
    variables["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    variables["params"]["bn"]["bias"] = rng.standard_normal(c).astype(np.float32)
    variables["batch_stats"]["bn"]["mean"] = rng.standard_normal(c).astype(np.float32)
    variables["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)

    def loss(yy):
        out, mut = jbn.apply(variables, yy, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mut)

    (_, (ref, mut)), ref_grad = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(y))

    bn = FrozenBatchNorm2d(c)
    bn.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["bn"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bn"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["bn"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["bn"]["var"])})
    t = torch.from_numpy(y).permute(0, 3, 1, 2).requires_grad_(True)
    out = bn_train_frozen_affine(t, bn)
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_grad), rtol=1e-4, atol=1e-6)
    stats = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-7)
    assert bn.weight.grad is None and bn.bias.grad is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_batch_mode_matches_jax(rng, dtype):
    """A cut backbone in bn_mode='batch': features and every running
    statistic after one forward against flax's mutated batch_stats (f32:
    rtol 1e-4 / atol 1e-4, the normalisation by the statistics of 96 to
    1,536 samples amplifying f32 rounding 13 times over; bf16 rounds every
    activation on both sides, so only the shapes, the finiteness and a
    loose 5e-2 of the largest value are held there), with the same
    state-dict keys as the frozen mode."""
    layers = (1, 1, 1, 1)
    jdt = getattr(jnp, dtype)
    jmodel = JaxResNetBackbone(layers=layers, bn_mode="batch", dtype=jdt)
    x = rng.standard_normal((2, 48, 64, 3)).astype(np.float32)
    variables = randomize_bn(jax.device_get(
        jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))), rng)
    ref, mut = jax.jit(lambda v, a: jmodel.apply(v, a, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = port_model(ResNetBackbone, variables, layers=layers,
                       bn_mode="batch", dtype=getattr(torch, dtype))
    frozen_keys = set(ResNetBackbone(layers=layers, device="cpu").state_dict())
    assert set(model.state_dict()) == frozen_keys
    ours = model(torch.from_numpy(x))
    ref_stats = pth_interop.from_jax_variables(
        {"batch_stats": jax.device_get(mut["batch_stats"])})
    for name in ("layer1", "layer4"):
        a = ours[name].detach().float().numpy()
        b = np.asarray(ref[name].astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            assert np.isfinite(a).all()
            assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max(), name
    if dtype == "float32":
        sd = model.state_dict()
        assert len(ref_stats) == 2 * (1 + 4 * 4)  # stem + 4 blocks x (3 + 1) BNs
        for k, v in ref_stats.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="bn_mode"):
        conv_bn_folded(torch.zeros(1, 3, 4, 4), model.conv1, model.bn1,
                       torch.float32, "live")


class JaxTinyBNSeg(nn.Module):
    """Three conv + BN pairs (the middle one a stride-1 3x3, the custom-VJP
    conv's path) and the two heads."""

    bn_mode: str = "batch"

    @nn.compact
    def __call__(self, x):
        kw = dict(bn_mode=self.bn_mode)
        h = nn.relu(jax_conv_bn_folded(self, x, 8, 3, "conv1", "bn1",
                                       stride=2, padding=1, **kw))
        h = nn.relu(jax_conv_bn_folded(self, h, 8, 3, "conv2", "bn2",
                                       stride=1, padding=1, **kw))
        h = jax_conv_bn_folded(self, h, 8, 3, "conv3", "bn3", stride=2,
                               padding=1, **kw)
        return (JaxConv2d(C, 1, name="layer5")(h),
                JaxConv2d(C, 1, name="layer6")(h))


class TinyBNSeg(torch.nn.Module):
    dtype = torch.float32

    def __init__(self, bn_mode):
        super().__init__()
        self.bn_mode = bn_mode
        for i, (cin, stride) in enumerate(((3, 2), (8, 1), (8, 2)), start=1):
            setattr(self, f"conv{i}", Conv2d(cin, 8, 3, stride=stride, padding=1))
            setattr(self, f"bn{i}", FrozenBatchNorm2d(8))
        self.layer5 = torch.nn.Conv2d(8, C, 1)
        self.layer6 = torch.nn.Conv2d(8, C, 1)

    def forward(self, x):
        h = x.contiguous().permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            h = conv_bn_folded(h, getattr(self, f"conv{i}"),
                               getattr(self, f"bn{i}"), self.dtype, self.bn_mode)
            if i < 3:
                h = F.relu(h)
        return tuple(head(h).permute(0, 2, 3, 1)
                     for head in (self.layer5, self.layer6))


def _load_tiny(tiny, variables):
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = p[f"conv{i}"]["conv"]["kernel"].transpose(3, 2, 0, 1)
        sd[f"bn{i}.weight"] = p[f"bn{i}"]["bn"]["scale"]
        sd[f"bn{i}.bias"] = p[f"bn{i}"]["bn"]["bias"]
        sd[f"bn{i}.running_mean"] = s[f"bn{i}"]["bn"]["mean"]
        sd[f"bn{i}.running_var"] = s[f"bn{i}"]["bn"]["var"]
    for head in ("layer5", "layer6"):
        sd[f"{head}.weight"] = p[head]["conv"]["kernel"].transpose(3, 2, 0, 1)
        sd[f"{head}.bias"] = p[head]["conv"]["bias"]
    tiny.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in sd.items()})


def _discriminators(state, jstate, levels):
    disc = JaxFCDiscriminator(num_classes=C, ndf=NDF)
    jd = {}
    for i in levels:
        v = jax.device_get(disc.init(jax.random.PRNGKey(10 + i),
                                     jnp.zeros((1,) + HW + (C,))))
        jd[i] = DiscriminatorState.create(
            jax.tree.map(jnp.asarray, v["params"]),
            make_discriminator_tx(base_lr=LR_D, num_steps=STEPS))
        d = FCDiscriminator(num_classes=C, ndf=NDF, device="cpu")
        assert pth_interop.load_into(d, pth_interop.from_jax_variables(v)) == []
        setattr(state, f"d{i}", d)
        setattr(state, f"d{i}_opt", make_discriminator_optimizer(d, LR_D))
    return disc, jstate.replace(d1=jd.get(1), d2=jd[2])


def _batch(rng, n):
    batch = {
        "images": rng.standard_normal((1, n, *HW, 3)).astype(np.float32),
        "labels": rng.integers(0, C, size=(1, n, *HW)),
        "target_images": rng.standard_normal((1, n, *HW, 3)).astype(np.float32),
    }
    batch["labels"][..., :3] = 255
    return batch


def _run_twin_steps(rng, jstep, step, jstate, state, n):
    for _ in range(2):
        batch = _batch(rng, n)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    assert state.step == int(jstate.step) == 2
    for i in (1, 2):
        jd, d = getattr(jstate, f"d{i}"), getattr(state, f"d{i}")
        if jd is not None:
            ref = pth_interop.from_jax_variables(
                {"params": jax.device_get(jd.params)})
            for k, v in d.state_dict().items():
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4,
                                           atol=2e-6, err_msg=f"D{i} {k}")
    return jstate


@pytest.mark.parametrize("bn_mode", ["batch", "frozen"])
def test_multi_level_step_with_bn_matches_jax(rng, bn_mode):
    """The multi-level step at a batch of two on twin conv + BN segmenters,
    2 steps: metrics, weights, the untouched BN affine and (batch mode) the
    running statistics after source-then-target forwards."""
    jseg = JaxTinyBNSeg(bn_mode=bn_mode)
    variables = randomize_bn(jax.device_get(jseg.init(
        jax.random.PRNGKey(5), jnp.zeros((1,) + HW + (3,)))), rng)
    for name, node in variables["params"].items():
        if "conv" in node:
            node["conv"]["kernel"] = (rng.standard_normal(
                node["conv"]["kernel"].shape) * 0.3).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        generator=GeneratorState.create(
            jparams, jax.tree.map(jnp.asarray, variables["batch_stats"]),
            make_generator_tx(generator_param_labels(jparams), base_lr=LR,
                              num_steps=STEPS)))
    tiny = TinyBNSeg(bn_mode)
    _load_tiny(tiny, variables)
    state = TrainState(model=tiny, g_opt=make_generator_optimizer(tiny, LR),
                       schedule=Schedule(LR, LR_D, STEPS))
    disc, jstate = _discriminators(state, jstate, (1, 2))
    jstep = jax_adversarial_step(jseg, disc, level="multi-level", input_hw=HW,
                                 donate=False)
    step = make_adversarial_step(level="multi-level", input_hw=HW)
    jstate = _run_twin_steps(rng, jstep, step, jstate, state, n=2)

    after = types.SimpleNamespace(model=TinyBNSeg(bn_mode))
    _load_tiny(after.model, _np_tree({
        "params": jstate.generator.params,
        "batch_stats": jstate.generator.batch_stats}))
    ref = after.model.state_dict()
    moved = 0
    for k, v in tiny.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=2e-6, err_msg=k)
        if "running" in k:
            start = variables["batch_stats"][k.split(".")[0]]["bn"][
                "mean" if k.endswith("mean") else "var"]
            moved += not np.array_equal(v.numpy(), start)
    assert moved == (6 if bn_mode == "batch" else 0)


# ----------------------------------------------------- --optim-dup-quirk


def test_param_multiplicity_on_resnet101():
    """{1: 1 stem conv, 3: 99 bottleneck convs, 4: 4 downsample convs} on the
    backbone, the heads once; name by name the JAX function's counts; VGG
    (all_1x) all once."""
    model = DeeplabMulti(device="cpu")
    mults = generator_param_multiplicity(model)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert set(mults) == trainable
    backbone = [k for n, k in mults.items() if not n.startswith(("layer5", "layer6"))]
    assert dict(collections.Counter(backbone)) == {1: 1, 3: 99, 4: 4}
    assert all(k == 1 for n, k in mults.items() if n.startswith(("layer5", "layer6")))
    shapes = jax.eval_shape(JaxDeeplabMulti(num_classes=19).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 128, 3), jnp.float32))
    ref = {}
    for path, k in jax.tree_util.tree_leaves_with_path(
            jax_param_multiplicity(shapes["params"])):
        ref[pth_interop._torch_key(tuple(p.key for p in path))] = k
    assert {n: ref[n] for n in trainable} == mults
    assert set(generator_param_multiplicity(model, all_1x=True).values()) == {1}


class _DupNet(torch.nn.Module):
    """Parameter names of the stem, a bottleneck conv, a downsample conv and a
    head, plus a frozen BN weight."""

    def __init__(self, rng):
        super().__init__()
        mk = lambda *s: torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)))
        self.conv1 = torch.nn.ParameterDict({"weight": mk(4, 3)})
        block = torch.nn.Module()
        block.conv2 = torch.nn.ParameterDict({"weight": mk(3, 3)})
        block.bn2 = torch.nn.ParameterDict({"weight": mk(3)})
        block.bn2["weight"].requires_grad_(False)
        block.downsample = torch.nn.ModuleList(
            [torch.nn.ParameterDict({"weight": mk(5)})])
        self.layer1 = torch.nn.ModuleList([block])
        self.layer5 = torch.nn.ParameterDict({"weight": mk(2, 2), "bias": mk(2)})


def test_kfold_sgd_matches_optax_chain(rng):
    """Five steps of the k-fold SGD (k = 1, 3, 4; heads at 10x; poly lr)
    against make_generator_tx(dup_mults=...) on the same gradients."""
    net = _DupNet(rng)
    leaves = {
        ("backbone", "conv1", "conv", "kernel"): net.conv1["weight"],
        ("backbone", "layer1_block0", "conv2", "conv", "kernel"):
            net.layer1[0].conv2["weight"],
        ("backbone", "layer1_block0", "downsample_conv", "conv", "kernel"):
            net.layer1[0].downsample[0]["weight"],
        ("layer5", "kernel"): net.layer5["weight"],
        ("layer5", "bias"): net.layer5["bias"],
    }
    params: dict = {}
    for path, p in leaves.items():
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(p.detach().numpy().copy())
    mults = jax_param_multiplicity(params)
    assert sorted(jax.tree.leaves(mults)) == [1, 1, 1, 3, 4]
    assert sorted(generator_param_multiplicity(net).values()) == [1, 1, 1, 3, 4]
    tx = make_generator_tx(generator_param_labels(params), base_lr=0.01,
                           num_steps=10, dup_mults=mults)
    opt_state = tx.init(params)
    opt = make_generator_optimizer(net, base_lr=0.01, dup_quirk=True)
    assert isinstance(opt, KFoldSGD)
    assert sorted((g["lr_mult"], g["k"]) for g in opt.param_groups) == [
        (1.0, 1), (1.0, 3), (1.0, 4), (10.0, 1)]

    def get(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    for step in range(5):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for path, p in leaves.items():
            p.grad = torch.from_numpy(np.asarray(get(grads, path)).copy())
        set_poly_lr(opt, 0.01, step, 10)
        opt.step()
    for path, p in leaves.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(get(params, path)),
                                   rtol=1e-5, atol=1e-7, err_msg=str(path))
    # k = 1 everywhere is torch.optim.SGD's rule
    a, b = _DupNet(np.random.default_rng(3)), _DupNet(np.random.default_rng(3))
    plain = make_generator_optimizer(a, base_lr=0.01)
    kfold = KFoldSGD([{"params": [p for p in b.parameters() if p.requires_grad]}],
                     lr=0.01, momentum=0.9, weight_decay=5e-4)
    for _ in range(3):
        for pa, pb in zip(a.parameters(), b.parameters()):
            pa.grad = torch.from_numpy(rng.standard_normal(pa.shape).astype(np.float32))
            pb.grad = pa.grad.clone()
        for g in plain.param_groups:
            g["lr"] = 0.01
        plain.step()
        kfold.step()
    for pa, pb in zip(a.parameters(), b.parameters()):
        np.testing.assert_allclose(pb.detach().numpy(), pa.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------------------- --model DeeplabVGG


def test_vgg_single_level_step_matches_jax(rng):
    """The single-level adversarial step with the VGG segmenter behind the
    (pred1, pred2) adapter, every parameter at 1x lr, 2 steps at a batch of
    one (conv weights rescaled to std sqrt(2 / fan_in) so that the
    gradients do not vanish)."""
    jmodel = jax_build._VGGAsMulti(num_classes=C)
    variables = _np_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(6), jnp.zeros((1,) + HW + (3,))))
    for name, node in variables["params"]["vgg"].items():
        if name != "classifier":
            fan_in = 9 * node["conv"]["kernel"].shape[2]
            node["conv"]["kernel"] *= np.float32(np.sqrt(2.0 / fan_in) / 0.01)
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    labels = generator_param_labels(jparams, all_1x=True)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        generator=GeneratorState.create(
            jparams, {}, make_generator_tx(labels, base_lr=LR, num_steps=STEPS)))
    model = build._VGGAsMulti(num_classes=C, device="cpu")
    assert pth_interop.load_into(
        model, pth_interop.from_jax_variables(variables)) == []
    assert set(model.state_dict()) == set(DeeplabVGG(device="cpu").state_dict())
    opt = make_generator_optimizer(model, LR, all_1x=True)
    assert [g["lr_mult"] for g in opt.param_groups] == [1.0]
    state = TrainState(model=model, g_opt=opt,
                       schedule=Schedule(LR, LR_D, STEPS))
    disc, jstate = _discriminators(state, jstate, (2,))
    jstep = jax_adversarial_step(jmodel, disc, level="single-level",
                                 input_hw=HW, donate=False)
    step = make_adversarial_step(level="single-level", input_hw=HW)
    jstate = _run_twin_steps(rng, jstep, step, jstate, state, n=1)
    ref = pth_interop.from_jax_variables(
        {"params": jax.device_get(jstate.generator.params)})
    start = pth_interop.from_jax_variables(variables)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=2e-6, err_msg=k)
    assert not torch.equal(model.state_dict()["features.0.weight"],
                           start["features.0.weight"])


@pytest.mark.parametrize("flags,kept", [
    (["--model", "DeeplabVGG", "--no-source-only"], None),
    (["--model", "DeeplabVGG", "--no-source-only", "--not-restore-last"], None),
    ([], ("layer5",)),
    (["--not-restore-last"], ("layer5", "layer6")),
    (["--num-classes", "19", "--bn-mode", "batch"], ("layer5",)),
], ids=["vgg", "vgg_not_restore_last", "resnet", "resnet_not_restore_last",
        "resnet_bn_batch"])
def test_restore_generator_surgery(tmp_path, flags, kept):
    """--restore-from over fresh weights: a VGG checkpoint (`features.*`,
    `classifier.*`) loads whole; a ResNet one skips layer5 at 19 classes and
    both heads with --not-restore-last (`kept`: the heads that keep their
    fresh weights), as JAX `restore_generator` does."""
    from adaptsegnet_tpu_torch.train.config import parse_args

    ckpt = str(tmp_path / "init.pth")
    cfg = parse_args(["--no-warper", *flags, "--restore-from", ckpt])
    source = build.build_generator(cfg, torch.Generator().manual_seed(1))
    pth_interop.save_torch_state_dict(
        {f"module.{k}": v for k, v in source.state_dict().items()}, ckpt)
    model = build.build_generator(cfg, torch.Generator().manual_seed(2))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    assert build.restore_generator(cfg, model) is True
    src = source.state_dict()
    for k, v in model.state_dict().items():
        fresh_kept = kept is not None and k.split(".")[0] in kept
        want = fresh[k] if fresh_kept else src[k]
        assert torch.equal(v, want), k
        if k.endswith("weight") and v.ndim == 4:
            assert not torch.equal(fresh[k], src[k]), k
    cfg.restore_from = ""
    assert build.restore_generator(cfg, model) is False
    cfg.restore_from = str(tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError, match="not found"):
        build.restore_generator(cfg, model)


# --------------------------------------------------- --source Synscapes


def make_synscapes(root, n=3, size_wh=(64, 32), seed=7):
    """A small Synscapes tree (img/rgb, img/class with Cityscapes raw ids),
    as tests/test_aux.py writes it."""
    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "img", "rgb"))
    os.makedirs(osp.join(root, "img", "class"))
    for i in range(n):
        img = rng.integers(0, 256, size=size_wh[::-1] + (3,), dtype=np.uint8)
        lab = rng.integers(0, 34, size=size_wh[::-1], dtype=np.uint8)
        Image.fromarray(img).save(osp.join(root, "img", "rgb", f"{i + 1}.png"))
        Image.fromarray(lab).save(osp.join(root, "img", "class", f"{i + 1}.png"))
    list_path = osp.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("".join(f"{i + 1}.png\n" for i in range(n)))
    return list_path


@pytest.mark.parametrize("kw", [
    dict(crop_size=(32, 16)), dict(max_iters=7),
    dict(crop_size=(48, 24), scale=True, mirror=True, seed=5)],
    ids=["resize", "max_iters", "scale_mirror"])
@pytest.mark.parametrize("with_list", [False, True])
def test_synscapes_items_match_jax(tmp_path, kw, with_list):
    root = str(tmp_path / "synscapes")
    list_path = make_synscapes(root)
    args = (root, list_path) if with_list else (root,)
    ours, ref = SynscapesDataset(*args, **kw), JaxSynscapesDataset(*args, **kw)
    assert len(ours) == len(ref) == (9 if "max_iters" in kw else 3)
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert a[3] == b[3]
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert set(np.unique(a[1])) <= set(range(19)) | {255}


# ------------------------------------------------------- --tensorboard


class _Writer:
    instances = []

    def __init__(self, log_dir):
        self.log_dir, self.calls, self.closed = log_dir, [], False
        _Writer.instances.append(self)

    def add_scalar(self, key, value, step):
        self.calls.append((key, value, step))

    def close(self):
        self.closed = True


@pytest.fixture
def tensorboardx(monkeypatch):
    """A stand-in `tensorboardX` module (the package is not installed)."""
    module = types.ModuleType("tensorboardX")
    module.SummaryWriter = _Writer
    _Writer.instances = []
    monkeypatch.setitem(sys.modules, "tensorboardX", module)
    return _Writer


def test_tensorboard_writer_every_10_steps(tensorboardx, tmp_path):
    log_dir = str(tmp_path / "log" / "run")
    logger = ScalarLogger(log_dir, tensorboard=True)
    for step in range(25):
        logger.log(step, {"loss_seg2": step * 0.5, "loss_D2": 1.0})
    logger.close()
    (writer,) = tensorboardx.instances
    assert writer.log_dir == log_dir and osp.isdir(log_dir) and writer.closed
    assert writer.calls == [(k, v, s) for s in (0, 10, 20)
                            for k, v in (("loss_seg2", s * 0.5), ("loss_D2", 1.0))]
    silent = ScalarLogger(log_dir, tensorboard=False)
    silent.log(0, {"x": 1.0})
    silent.close()
    assert len(tensorboardx.instances) == 1
