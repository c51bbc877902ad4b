"""The eval slice as a whole: the port's eval fn, hist fn, Evaluator and CLIs
vs the JAX package's, on the same weights and images."""

import glob
import os.path as osp

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image

from adaptsegnet_tpu.data import CityscapesDataset as JaxCityscapesDataset
from adaptsegnet_tpu.eval.evaluator import (
    Evaluator as JaxEvaluator,
    make_eval_fn as jax_make_eval_fn,
)
from adaptsegnet_tpu.models import DeeplabMulti as JaxDeeplabMulti
from adaptsegnet_tpu.ops.resize import upsample_logits as jax_upsample_logits
from adaptsegnet_tpu_torch.cli import evaluate as cli_evaluate
from adaptsegnet_tpu_torch.cli import iou as cli_iou
from adaptsegnet_tpu_torch.data import CityscapesDataset, lists
from adaptsegnet_tpu_torch.eval.evaluator import (
    Evaluator,
    make_eval_fn,
    make_eval_hist_fn,
)
from adaptsegnet_tpu_torch.models import DeeplabMulti
from adaptsegnet_tpu_torch.ops.metrics import fast_hist, fast_hist_torch
from adaptsegnet_tpu_torch.utils import pth_interop
from tests.test_torch_models import port_model, randomize_bn

IN_HW, OUT_HW = (64, 96), (128, 192)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxDeeplabMulti(num_classes=19)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1,) + IN_HW + (3,)))
    variables = randomize_bn(jax.device_get(variables),
                             np.random.default_rng(11))
    return jmodel, variables, port_model(DeeplabMulti, variables)


def jax_logits_up(jmodel, variables, images):
    """JAX f32 upsampled pred2 logits, for the top-2 margins."""
    fn = jax.jit(lambda v, x: jax_upsample_logits(
        jmodel.apply(v, x)[1], OUT_HW, exact=True))
    return np.asarray(fn(variables, jnp.asarray(images)))


def assert_masks_agree(ours, ref, up):
    """>= 99.9 % equal; every mismatch at a JAX top-2 margin < 1e-3 (f32
    sums in another order flip only near-ties)."""
    eq = ours == ref
    assert eq.mean() >= 0.999, f"only {eq.mean():.4%} agreement"
    s = np.sort(up, axis=-1)
    margin = s[..., -1] - s[..., -2]
    assert (margin[~eq] < 1e-3).all()


def test_eval_fn_matches_jax(models):
    jmodel, variables, model = models
    images = (np.random.default_rng(3).standard_normal((1,) + IN_HW + (3,))
              * 50).astype(np.float32)
    ref = np.asarray(jax_make_eval_fn(jmodel, out_hw=OUT_HW)(
        variables, jnp.asarray(images)))
    ours = make_eval_fn(model, out_hw=OUT_HW)(torch.from_numpy(images))
    assert ours.dtype == torch.uint8 and ours.shape == (1,) + OUT_HW
    assert len(np.unique(ref)) > 1  # the weights give a non-trivial mask
    assert_masks_agree(ours.numpy(), ref,
                       jax_logits_up(jmodel, variables, images))


def test_bf16_tails_agree(models):
    """bf16 eval: the kernel tail (on the CPU its f32 plain version) and the
    plain bf16 tail pick the same class except at bf16 near-ties."""
    _, _, model = models
    images = torch.from_numpy(
        (np.random.default_rng(4).standard_normal((1,) + IN_HW + (3,))
         * 50).astype(np.float32))
    kernel_tail = make_eval_fn(model, out_hw=OUT_HW, dtype=torch.bfloat16)
    plain_tail = make_eval_fn(model, out_hw=OUT_HW, dtype=torch.bfloat16,
                              use_kernel_tail=False)
    a, b = kernel_tail(images), plain_tail(images)
    assert a.dtype == b.dtype == torch.uint8 and a.shape == b.shape
    assert (a == b).float().mean() > 0.99


def test_hist_fn_matches_numpy(models, rng):
    _, _, model = models
    images = torch.from_numpy(
        (rng.standard_normal((2,) + IN_HW + (3,)) * 50).astype(np.float32))
    labels = rng.integers(0, 19, (2,) + OUT_HW)
    labels[:, :10] = 255  # ignore id
    masks, hist = make_eval_hist_fn(model, out_hw=OUT_HW)(
        images, torch.from_numpy(labels))
    assert hist.dtype == torch.int64
    np.testing.assert_array_equal(hist.numpy(),
                                  fast_hist(labels, masks.numpy(), 19))
    pred = rng.integers(0, 19, 5000)
    lab = rng.integers(-1, 21, 5000)
    np.testing.assert_array_equal(
        fast_hist_torch(torch.from_numpy(lab), torch.from_numpy(pred), 19).numpy(),
        fast_hist(lab, pred, 19))


def test_evaluator_pngs_match_jax(models, tmp_path):
    jmodel, variables, model = models
    root = str(tmp_path / "cs")
    list_path = lists.make_synthetic_cityscapes(
        root, "val", n=3, size_wh=IN_HW[::-1])
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    JaxEvaluator(jmodel, out_hw=OUT_HW, save_dir=str(jax_dir)).run(
        variables, JaxCityscapesDataset(root, list_path, crop_size=IN_HW[::-1]),
        batch_size=1, num_workers=1)
    ds = CityscapesDataset(root, list_path, crop_size=IN_HW[::-1])
    # batch 2 over 3 images: the ragged tail is padded, then dropped.
    written = Evaluator(model, out_hw=OUT_HW, save_dir=str(port_dir)).run(
        ds, batch_size=2, num_workers=2)
    assert len(written) == 3
    images = np.stack([ds[i][0] for i in range(3)])
    up = jax_logits_up(jmodel, variables, images)
    for i, path in enumerate(written):
        name = osp.basename(path)
        ours = np.array(Image.open(path))
        ref = np.array(Image.open(jax_dir / name))
        assert ours.shape == OUT_HW
        assert_masks_agree(ours, ref, up[i])
        assert osp.exists(port_dir / name.replace(".png", "_color.png"))


def test_run_streaming_hist_matches_pngs(models, tmp_path):
    _, _, model = models
    root = str(tmp_path / "cs")
    list_path = lists.make_synthetic_cityscapes(
        root, "val", n=3, size_wh=IN_HW[::-1])
    ds = CityscapesDataset(root, list_path, crop_size=IN_HW[::-1])
    rng = np.random.default_rng(5)
    gts = {ds[i][2]: rng.integers(0, 19, OUT_HW) for i in range(3)}
    ev = Evaluator(model, out_hw=OUT_HW, save_dir=str(tmp_path / "out"))
    # batch 2 over 3 images: the padded item carries all-ignore labels.
    hist = ev.run_streaming(ds, gts.__getitem__, batch_size=2, num_workers=1)
    ref = sum(fast_hist(gts[name], np.array(Image.open(
        tmp_path / "out" / osp.basename(name))), 19) for name in gts)
    assert hist.dtype == np.int64
    np.testing.assert_array_equal(hist, ref)
    assert hist.sum() == 3 * OUT_HW[0] * OUT_HW[1]


def test_cli_evaluate_then_iou(tmp_path, capsys):
    root = str(tmp_path / "cs")
    list_path = lists.make_synthetic_cityscapes(
        root, "val", n=2, size_wh=IN_HW[::-1])
    with open(list_path) as f:
        names = f.read().split()
    gt_dir, labels = lists.make_synthetic_cityscapes_gt(
        root, names, size_wh=OUT_HW[::-1])
    lists.write_devkit(str(tmp_path / "devkit"), names, labels)
    ckpt = str(tmp_path / "GTA5_1.pth")
    model = DeeplabMulti(device="cpu", generator=torch.Generator().manual_seed(2))
    pth_interop.save_torch_state_dict(model.state_dict(), ckpt)
    pred_dir = str(tmp_path / "result")
    cli_evaluate.main([
        "--cpu", "--data-dir", root, "--data-list", list_path,
        "--restore-from", ckpt, "--save", pred_dir,
        "--input-size", f"{IN_HW[1]},{IN_HW[0]}",
        "--output-size", f"{OUT_HW[1]},{OUT_HW[0]}",
    ])
    assert len(glob.glob(osp.join(pred_dir, "*_color.png"))) == 2
    cli_iou.main(["--gt_dir", gt_dir, "--pred_dir", pred_dir,
                  "--devkit_dir", str(tmp_path / "devkit"), "--single-dir"])
    assert "===> mIoU:" in capsys.readouterr().out
