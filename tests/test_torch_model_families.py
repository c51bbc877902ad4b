"""The port's single-head ResNet ('Oracle') and VGG-16 segmenters and their
parts against the JAX package's, on the same weights: the ceil-mode and 2x2
pools (values and the backward's tie rule), the 'first2' ASPP sum, the
models in f32 (rtol 1e-3 / atol 1e-4, as tests/test_torch_models.py holds
DeeplabMulti), the reference-key round trip through the JAX loaders, and
`cli.evaluate --model Oracle|DeeplabVGG` against the JAX evaluator's masks.
"""

import os.path as osp

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.data import CityscapesDataset as JaxCityscapesDataset
from adaptsegnet_tpu.eval.evaluator import Evaluator as JaxEvaluator
from adaptsegnet_tpu.models import DeeplabSingle as JaxDeeplabSingle
from adaptsegnet_tpu.models import DeeplabVGG as JaxDeeplabVGG
from adaptsegnet_tpu.models.deeplab_resnet import (
    ClassifierModule as JaxClassifierModule,
)
from adaptsegnet_tpu.models.layers import max_pool_2x2_s2 as jax_pool2
from adaptsegnet_tpu.models.layers import max_pool_3x3_s2 as jax_pool3
from adaptsegnet_tpu.ops.resize import upsample_logits as jax_upsample_logits
from adaptsegnet_tpu.utils import pth_interop as jax_io
from adaptsegnet_tpu_torch.cli import evaluate as cli_evaluate
from adaptsegnet_tpu_torch.data import CityscapesDataset, lists
from adaptsegnet_tpu_torch.models import ClassifierModule, DeeplabSingle, DeeplabVGG
from adaptsegnet_tpu_torch.models.layers import max_pool_2x2_s2, max_pool_3x3_s2
from adaptsegnet_tpu_torch.utils import pth_interop
from tests.test_torch_eval import assert_masks_agree
from tests.test_torch_models import port_model, randomize_bn

IN_HW, OUT_HW = (64, 96), (128, 192)


def _np_tree(variables):
    return jax.tree.map(lambda a: np.array(a, np.float32),  # writable copies
                        jax.device_get(variables))


@pytest.fixture(scope="module")
def oracle():
    jmodel = JaxDeeplabSingle(num_classes=19)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1,) + IN_HW + (3,)))
    variables = randomize_bn(jax.device_get(variables),
                             np.random.default_rng(21))
    return jmodel, variables


@pytest.fixture(scope="module")
def vgg():
    """DeeplabVGG at its own widths; the init's N(0, 0.01) conv weights are
    rescaled to std sqrt(2 / fan_in) so that the activations neither vanish
    nor grow through the 15 convs, and the biases drawn."""
    jmodel = JaxDeeplabVGG(num_classes=19)
    variables = _np_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(22)
    for name, node in variables["params"].items():
        convs = ([b["conv"] for b in node.values()] if name == "classifier"
                 else [node["conv"]])
        for conv in convs:
            if name != "classifier":
                fan_in = 9 * conv["kernel"].shape[2]
                conv["kernel"] *= np.float32(np.sqrt(2.0 / fan_in) / 0.01)
            conv["bias"] = (rng.standard_normal(conv["bias"].shape)
                            * 0.05).astype(np.float32)
    return jmodel, variables


@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("hw", [(12, 16), (13, 15), (9, 12)])
def test_pool_3x3_matches_jax(rng, hw, ceil_mode):
    """Values exact; the backward routes each window's cotangent to the
    first maximum in scan order in both (integer inputs force ties)."""
    x = rng.integers(0, 4, (2,) + hw + (3,)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_pool3(a, ceil_mode), jnp.asarray(x))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ours = max_pool_3x3_s2(t, ceil_mode)
    ours.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(ours.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(12, 16), (13, 15)])
def test_pool_2x2_matches_jax(rng, hw):
    x = rng.integers(0, 3, (2,) + hw + (3,)).astype(np.float32)
    ref, vjp = jax.vjp(jax_pool2, jnp.asarray(x))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ours = max_pool_2x2_s2(t)
    ours.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(ours.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    np.testing.assert_array_equal(t.grad.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("aspp_sum", ["first2", "all"])
def test_classifier_module_matches_flax(rng, aspp_sum):
    jhead = JaxClassifierModule(19, aspp_sum=aspp_sum)
    x = rng.standard_normal((1, 14, 18, 32)).astype(np.float32)
    variables = _np_tree(jhead.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    for node in variables["params"].values():
        node["conv"]["bias"] = rng.standard_normal(19).astype(np.float32)
    ref = np.asarray(jhead.apply(variables, jnp.asarray(x)))
    head = ClassifierModule(32, 19, aspp_sum)
    sd = pth_interop.from_jax_variables(
        {"params": {"layer5": variables["params"]}})
    head.load_state_dict({k.removeprefix("layer5."): v for k, v in sd.items()})
    with torch.no_grad():
        ours = head(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    other = ClassifierModule(32, 19, "all" if aspp_sum == "first2" else "first2")
    other.load_state_dict(head.state_dict())
    with torch.no_grad():
        diff = other(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32)
    assert not torch.allclose(diff, ours, atol=1e-3)  # the two sums differ
    with pytest.raises(ValueError, match="aspp_sum"):
        ClassifierModule(32, 19, "first3")


@pytest.mark.parametrize("aspp_sum", ["first2", "all"])
def test_deeplab_single_matches_flax(oracle, rng, aspp_sum):
    _, variables = oracle
    jmodel = JaxDeeplabSingle(num_classes=19, aspp_sum=aspp_sum)
    x = rng.standard_normal((1,) + IN_HW + (3,)).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
    model = port_model(DeeplabSingle, variables, aspp_sum=aspp_sum)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    assert ours.shape == ref.shape == (1, 9, 13, 19)  # the ceil-mode pool
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("return_features", [False, True])
def test_deeplab_vgg_matches_flax(vgg, rng, return_features):
    jmodel, variables = vgg
    x = rng.standard_normal((1, 40, 56, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.apply, static_argnums=2)(
        variables, jnp.asarray(x), return_features))
    model = port_model(DeeplabVGG, variables)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), return_features=return_features)
    assert ours.shape == ref.shape == (1, 5, 7, 1024 if return_features else 19)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-3, atol=1e-4)


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_vgg_reference_keys_round_trip(vgg, rng):
    """The port's state dict has the reference's keys: the JAX loader reads
    it back into the same flax tree, the JAX exporter writes the same dict
    (also through the train adapter's `vgg` level)."""
    _, variables = vgg
    model = port_model(DeeplabVGG, variables)
    sd = _numpy_sd(model)
    assert "features.29.weight" in sd and "classifier.conv2d_list.3.bias" in sd
    back = jax_io.vgg_state_dict_to_variables(sd)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    ref, got = flat(variables["params"]), flat(back["params"])
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    exported = jax_io.variables_to_vgg_state_dict(variables)
    assert exported.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(exported[k], sd[k], err_msg=k)
    wrapped = pth_interop.from_jax_variables(
        {"params": {"vgg": variables["params"]}})
    assert wrapped.keys() == sd.keys()


def test_oracle_reference_keys_round_trip(oracle):
    _, variables = oracle
    model = port_model(DeeplabSingle, variables)
    sd = _numpy_sd(model)
    assert "layer5.conv2d_list.0.weight" in sd and "layer6.conv2d_list.0.weight" not in sd
    back = jax_io.resnet_state_dict_to_variables(sd)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    ref, got = flat(variables), flat(back)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    exported = jax_io.variables_to_resnet_state_dict(variables)
    assert exported.keys() == sd.keys()


def _jax_eval(jmodel, variables, root, list_path, out_dir):
    ds = JaxCityscapesDataset(root, list_path, crop_size=IN_HW[::-1])
    JaxEvaluator(jmodel, out_hw=OUT_HW, output_index=0,
                 save_dir=str(out_dir)).run(variables, ds, batch_size=1,
                                            num_workers=1)
    images = np.stack([ds[i][0] for i in range(len(ds))])
    up = jax.jit(lambda v, x: jax_upsample_logits(
        jmodel.apply(v, x), OUT_HW, exact=True))(variables, jnp.asarray(images))
    return np.asarray(up)


@pytest.mark.parametrize("name", ["Oracle", "DeeplabVGG"])
def test_cli_evaluate_single_output_models(request, tmp_path, name):
    """`cli.evaluate --cpu --model <name>` loads a reference-key checkpoint
    and writes the masks the JAX evaluator writes (>= 99.9 % equal,
    mismatches only at a JAX top-2 margin < 1e-3)."""
    jmodel, variables = request.getfixturevalue(
        "oracle" if name == "Oracle" else "vgg")
    cls = DeeplabSingle if name == "Oracle" else DeeplabVGG
    root = str(tmp_path / "cs")
    list_path = lists.make_synthetic_cityscapes(root, "val", n=2,
                                                size_wh=IN_HW[::-1])
    ckpt = str(tmp_path / "ckpt.pth")
    pth_interop.save_torch_state_dict(
        port_model(cls, variables).state_dict(), ckpt)
    up = _jax_eval(jmodel, variables, root, list_path, tmp_path / "jax")
    pred_dir = tmp_path / "port"
    cli_evaluate.main([
        "--cpu", "--model", name, "--data-dir", root, "--data-list", list_path,
        "--restore-from", ckpt, "--save", str(pred_dir),
        "--input-size", f"{IN_HW[1]},{IN_HW[0]}",
        "--output-size", f"{OUT_HW[1]},{OUT_HW[0]}"])
    ds = CityscapesDataset(root, list_path, crop_size=IN_HW[::-1])
    for i in range(len(ds)):
        base = osp.basename(ds[i][-1])
        ours = np.array(Image.open(pred_dir / base))
        ref = np.array(Image.open(tmp_path / "jax" / base))
        assert ours.shape == OUT_HW and len(np.unique(ref)) > 1
        assert_masks_agree(ours, ref, up[i])
        assert osp.exists(pred_dir / base.replace(".png", "_color.png"))


def test_cli_evaluate_rejects_unknown_choices(tmp_path):
    with pytest.raises(NotImplementedError):
        cli_evaluate.main(["--cpu", "--model", "Nope", "--restore-from", "x",
                           "--save", str(tmp_path / "o")])
    with pytest.raises(ValueError, match="aspp_sum"):
        cli_evaluate.main(["--cpu", "--model", "Oracle", "--aspp-sum", "some",
                           "--restore-from", "x", "--save", str(tmp_path / "o")])
