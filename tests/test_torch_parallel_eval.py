"""Data-parallel eval and the CLIs' --num-devices, on gloo ranks on the CPU.

A group of 2 ranks (`parallel.launch`, cpu=True, each launch with its own
time limit) runs `Evaluator.run_streaming` at a global batch of 2 over 5
images (a ragged tail) with ignore pixels in the labels; its histogram and
every PNG must equal the 1-process run at batch 1 exactly
(tests/test_parallel.py:83 asks the same of the JAX mesh), and a batch that
does not divide by the group raises. Then `cli.train --cpu --num-devices 2`
(multi-level, full DeeplabMulti at 64x64, 2 steps) writes one set of
snapshots, from rank 0 (the steps' numerics against one process are in
tests/test_torch_parallel_steps.py), and `cli.evaluate --cpu
--num-devices 2` writes every PNG once.
"""

import glob
import os
import os.path as osp

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from adaptsegnet_tpu_torch.cli import evaluate as cli_evaluate
from adaptsegnet_tpu_torch.cli import train as cli_train
from adaptsegnet_tpu_torch.data import CityscapesDataset, lists
from adaptsegnet_tpu_torch.eval.evaluator import Evaluator
from adaptsegnet_tpu_torch.models import DeeplabMulti
from adaptsegnet_tpu_torch.models.layers import FrozenBatchNorm2d
from adaptsegnet_tpu_torch.parallel import group
from adaptsegnet_tpu_torch.utils import pth_interop

IN_HW, OUT_HW = (64, 96), (128, 192)
N_IMAGES = 5
LAUNCH_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_rank():
    """The ranks take one CPU thread each: the suite's workers already
    share the cores, and oversubscribed threads spin."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def checkpoint(path):
    """DeeplabMulti with checkpoint-like BN statistics (at init the logits
    nearly vanish and every mask is one class), saved as a .pth."""
    g = torch.Generator().manual_seed(4)
    model = DeeplabMulti(device="cpu", generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                c = m.weight.shape
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g))
                m.running_var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
    pth_interop.save_torch_state_dict(model.state_dict(), path)


def evaluator(ckpt, save_dir, mesh=None):
    model = DeeplabMulti(device="cpu")
    pth_interop.load_into(model, pth_interop.load_torch_state_dict(ckpt))
    return Evaluator(model, out_hw=OUT_HW, save_dir=save_dir, mesh=mesh)


def rank_eval(ckpt, root, list_path, gts, save_dir):
    """This rank's run_streaming at a global batch of 2, then an
    indivisible batch of 3 (which must raise)."""
    ev = evaluator(ckpt, save_dir, mesh=dist.group.WORLD)
    ds = CityscapesDataset(root, list_path, crop_size=IN_HW[::-1])
    hist = ev.run_streaming(ds, gts.__getitem__, batch_size=2, num_workers=1)
    view, local_batch, r, _ = ev._local(ds, 2)
    names = [view[i][-1] for i in range(len(view))]
    try:
        ev.run(ds, batch_size=3)
        raised = None
    except ValueError as e:
        raised = str(e)
    assert r == group.rank()
    return hist, (names, local_batch), raised, r


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_eval")
    root = str(tmp / "cs")
    list_path = lists.make_synthetic_cityscapes(root, "val", n=N_IMAGES,
                                                size_wh=IN_HW[::-1])
    ckpt = str(tmp / "m.pth")
    checkpoint(ckpt)
    ds = CityscapesDataset(root, list_path, crop_size=IN_HW[::-1])
    rng = np.random.default_rng(9)
    gts = {}
    for i in range(N_IMAGES):
        label = rng.integers(0, 19, OUT_HW)
        label[rng.random(OUT_HW) < 0.2] = 255
        gts[ds[i][2]] = label
    one_dir, two_dir = str(tmp / "one"), str(tmp / "two")
    hist_one = evaluator(ckpt, one_dir).run_streaming(
        ds, gts.__getitem__, batch_size=1, num_workers=1)
    ranks = group.launch(rank_eval, 2, cpu=True,
                         args=(ckpt, root, list_path, gts, two_dir),
                         timeout=LAUNCH_TIMEOUT_S)
    return hist_one, ranks, one_dir, two_dir, gts


def test_two_rank_histogram_equals_one_process(eval_runs):
    hist_one, ranks, *_ = eval_runs
    assert hist_one.sum() > 0 and (np.diag(hist_one) > 0).sum() > 1
    for hist, *_ in ranks:  # every rank holds the global histogram
        np.testing.assert_array_equal(hist, hist_one)


def test_two_rank_pngs_equal_one_process(eval_runs):
    _, ranks, one_dir, two_dir, gts = eval_runs
    names = sorted(os.listdir(one_dir))
    assert len(names) == 2 * N_IMAGES  # raw ids + palette
    assert sorted(os.listdir(two_dir)) == names
    for name in names:
        np.testing.assert_array_equal(
            np.array(Image.open(osp.join(two_dir, name))),
            np.array(Image.open(osp.join(one_dir, name))), err_msg=name)


def test_ranks_take_interleaved_slices(eval_runs):
    """Rank 0 takes images 0, 2, 4 (its last local batch padded), rank 1
    images 1 and 3, each at a local batch of 1; the ignore labels and the
    padding count nowhere."""
    hist_one, ranks, _, _, gts = eval_runs
    names = list(gts)
    assert [r[3] for r in ranks] == [0, 1]
    assert ranks[0][1] == (names[0::2], 1)
    assert ranks[1][1] == (names[1::2], 1)
    valid = sum(int((label != 255).sum()) for label in gts.values())
    assert hist_one.sum() == valid


def test_indivisible_batch_raises(eval_runs):
    _, ranks, *_ = eval_runs
    for _, _, raised, _ in ranks:
        assert raised is not None and "not divisible" in raised


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    gta = lists.make_synthetic_gta5(str(tmp / "gta5"), n=4, size_wh=(64, 64))
    cs = lists.make_synthetic_cityscapes(str(tmp / "cs"), "train", n=4,
                                         size_wh=(64, 64))
    return tmp, [
        "--cpu", "--no-warper", "--no-source-only", "--level", "multi-level",
        "--data-dir", str(tmp / "gta5"), "--data-list", gta,
        "--data-dir-target", str(tmp / "cs"), "--data-list-target", cs,
        "--input-size", "64,64", "--input-size-target", "64,64",
        "--num-steps", "100", "--num-steps-stop", "2", "--restore-from", "",
        "--batch-size", "2", "--num-workers", "1"]


def test_cli_train_two_ranks_snapshot_from_rank0(train_data, capfd):
    tmp, flags = train_data
    two = str(tmp / "snap2")
    summary = cli_train.main([*flags, "--num-devices", "2",
                              "--snapshot-dir", two])
    out = capfd.readouterr().out
    # rank 0 alone prints the loss lines and writes the snapshots
    assert out.count("iter =") == 2, out
    assert len(summary["snapshots"]) == 1
    files = sorted(os.listdir(osp.join(two, "multi_level")))
    assert files == ["GTA5_2.pth", "GTA5_2_D1.pth", "GTA5_2_D2.pth",
                     "full_state"]
    snap = pth_interop.load_torch_state_dict(osp.join(two, "multi_level",
                                                      "GTA5_2.pth"))
    model = DeeplabMulti(device="cpu", generator=torch.Generator().manual_seed(1338))
    assert pth_interop.load_into(model, snap) == []
    init = DeeplabMulti(device="cpu", generator=torch.Generator().manual_seed(1338))
    assert not torch.equal(model.layer6.conv2d_list[0].weight,
                           init.layer6.conv2d_list[0].weight)  # trained
    assert set(summary["final_metrics"]) == {
        "loss_seg1", "loss_seg2", "loss_adv_target1", "loss_adv_target2",
        "loss_D1", "loss_D2"}  # the stop vote is not among them
    for k, v in summary["final_metrics"].items():
        assert np.isfinite(v), k


def test_cli_evaluate_two_ranks_writes_every_png_once(tmp_path):
    root = str(tmp_path / "cs")
    list_path = lists.make_synthetic_cityscapes(root, "val", n=3,
                                                size_wh=IN_HW[::-1])
    ckpt = str(tmp_path / "m.pth")
    checkpoint(ckpt)
    pred = str(tmp_path / "pred")
    cli_evaluate.main([
        "--cpu", "--num-devices", "2", "--batch-size", "2",
        "--data-dir", root, "--data-list", list_path, "--restore-from", ckpt,
        "--save", pred, "--input-size", f"{IN_HW[1]},{IN_HW[0]}",
        "--output-size", f"{OUT_HW[1]},{OUT_HW[0]}"])
    with open(list_path) as f:
        names = sorted(osp.basename(n) for n in f.read().split())
    assert sorted(osp.basename(p) for p in glob.glob(
        osp.join(pred, "*_color.png"))) == [n.replace(".png", "_color.png")
                                            for n in names]
    assert len(os.listdir(pred)) == 2 * len(names)
