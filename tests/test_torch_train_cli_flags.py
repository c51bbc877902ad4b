"""`cli.train --cpu` with each of the remaining train flags (--bn-mode
batch with --tensorboard, --optim-dup-quirk, --source Synscapes, --model
DeeplabVGG, --batch-size 2 in bf16) for 2 steps on synthetic data. Apart
from tests/test_torch_train_flags.py, which holds the same flags against
the JAX package, so that the test runner can put the two on two workers.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from adaptsegnet_tpu_torch.cli import train as cli_train
from adaptsegnet_tpu_torch.data import lists
from adaptsegnet_tpu_torch.models import DeeplabMulti, DeeplabVGG
from adaptsegnet_tpu_torch.utils import pth_interop
from tests.test_torch_train_flags import make_synscapes, tensorboardx  # noqa: F401


# ----------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("flags")
    gta = lists.make_synthetic_gta5(str(root / "gta5"), n=3, size_wh=(64, 64))
    cs = lists.make_synthetic_cityscapes(str(root / "cs"), "train", n=3,
                                         size_wh=(64, 64))
    syn = make_synscapes(str(root / "synscapes"), size_wh=(64, 64))
    return {"gta": gta, "cs": cs, "syn": syn}


CLI_CASES = {
    "bn_batch": (["--no-warper", "--bn-mode", "batch", "--tensorboard"],
                 "source_only"),
    "dup_quirk": (["--no-warper", "--optim-dup-quirk"], "source_only"),
    "synscapes": (["--no-warper", "--source", "Synscapes"], "source_only"),
    "vgg": (["--model", "DeeplabVGG", "--no-source-only", "--no-warper"],
            "single_level"),
    "batch2_bf16": (["--no-warper", "--no-source-only", "--level", "multi-level",
                     "--batch-size", "2", "--compute-dtype", "bfloat16"],
                    "multi_level"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_train_cli_flags(tensorboardx, train_data, tmp_path, case):
    """`cli.train --cpu` for 2 steps with each flag on synthetic data: finite
    losses near ln 19 (with batch statistics the random net's logits do not
    vanish, so there only below 6), a snapshot that loads back into the
    model family, and what the flag is for (the running statistics moved, the k-fold optimizer
    built, tensorboard scalars written at step 0, a batch of two)."""
    flags, sub = CLI_CASES[case]
    src = train_data["syn" if case == "synscapes" else "gta"]
    snap = str(tmp_path / "snap")
    out = cli_train.main([
        "--cpu", *flags, "--data-dir", osp.dirname(src), "--data-list", src,
        "--data-dir-target", osp.dirname(train_data["cs"]),
        "--data-list-target", train_data["cs"], "--input-size", "64,64",
        "--input-size-target", "64,64", "--num-steps", "100",
        "--num-steps-stop", "2", "--restore-from", "", "--snapshot-dir", snap,
        "--log-dir", str(tmp_path / "log"), "--num-workers", "2"])
    assert out["steps"] == 2
    assert all(np.isfinite(v) for v in out["final_metrics"].values())
    loss = out["final_metrics"]["loss_seg2"]
    assert loss < 6 if case == "bn_batch" else abs(loss - np.log(19)) < 0.1
    sd = pth_interop.load_torch_state_dict(osp.join(snap, sub, "GTA5_2.pth"))
    if case == "vgg":
        model = DeeplabVGG(device="cpu")
        assert osp.exists(osp.join(snap, sub, "GTA5_2_D2.pth"))
    else:
        model = DeeplabMulti(device="cpu")
    assert pth_interop.load_into(model, sd) == []
    moved = any(not torch.equal(v, torch.zeros_like(v))
                for k, v in sd.items() if k.endswith("running_mean"))
    assert moved == (case == "bn_batch")
    if case == "bn_batch":
        (writer,) = tensorboardx.instances
        assert {c[2] for c in writer.calls} == {0} and writer.closed
        assert {c[0] for c in writer.calls} == {"loss_seg2"}
    else:
        assert not tensorboardx.instances
    full = torch.load(osp.join(snap, sub, "full_state", "state_2.pt"),
                      weights_only=False)
    ks = sorted(g.get("k", 1) for g in full["g_opt"]["param_groups"])
    assert ks == ([1, 1, 3, 4] if case == "dup_quirk" else [1] * len(ks))
