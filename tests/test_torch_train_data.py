"""The port's train-side data, logging and snapshot helpers against the JAX
package's: the same files give the same arrays, the same seeds the same
batch order, and the snapshots the reference's names and keys."""

import os

import numpy as np
import torch

from adaptsegnet_tpu.data import lists as jax_lists
from adaptsegnet_tpu.data.cityscapes import CityscapesDataset as JaxCityscapes
from adaptsegnet_tpu.data.gta5 import GTA5Dataset as JaxGTA5
from adaptsegnet_tpu.data.pipeline import epoch_batches as jax_epoch_batches
from adaptsegnet_tpu.utils import logging as jax_logging
from adaptsegnet_tpu_torch.data import CityscapesDataset, GTA5Dataset, lists
from adaptsegnet_tpu_torch.data.pipeline import PrefetchLoader, epoch_batches
from adaptsegnet_tpu_torch.models import DeeplabMulti, FCDiscriminator
from adaptsegnet_tpu_torch.utils import checkpoint
from adaptsegnet_tpu_torch.utils.logging import format_losses


def test_synthetic_gta5_and_datasets_match_jax(tmp_path):
    """make_synthetic_gta5 writes the JAX fixture's bytes; GTA5Dataset and
    the train-side CityscapesDataset (list repeated to max_iters) return
    the JAX datasets' arrays exactly."""
    ours = lists.make_synthetic_gta5(str(tmp_path / "a"), n=3, size_wh=(40, 24))
    ref = jax_lists.make_synthetic_gta5(str(tmp_path / "b"), n=3, size_wh=(40, 24))
    for sub in ("images", "labels"):
        for name in os.listdir(tmp_path / "b" / sub):
            assert ((tmp_path / "a" / sub / name).read_bytes()
                    == (tmp_path / "b" / sub / name).read_bytes())
    a = GTA5Dataset(str(tmp_path / "a"), ours, max_iters=7, crop_size=(32, 16))
    b = JaxGTA5(str(tmp_path / "b"), ref, max_iters=7, crop_size=(32, 16))
    assert len(a) == len(b) == 9
    for i in (0, 4):
        for x, y in zip(a[i][:3], b[i][:3]):
            np.testing.assert_array_equal(x, y)
        assert a[i][3] == b[i][3]
    assert set(np.unique(a[0][1])) <= set(range(19)) | {255}

    cs = lists.make_synthetic_cityscapes(str(tmp_path / "cs"), "train", n=2,
                                         size_wh=(40, 24))
    a = CityscapesDataset(str(tmp_path / "cs"), cs, crop_size=(32, 16),
                          set="train", max_iters=5)
    b = JaxCityscapes(str(tmp_path / "cs"), cs, max_iters=5, crop_size=(32, 16),
                      set="train")
    assert len(a) == len(b) == 6
    np.testing.assert_array_equal(a[3][0], b[3][0])


def test_batch_order_matches_jax():
    ours = epoch_batches(10, 3, seed=5)
    ref = jax_epoch_batches(10, 3, shuffle=True, seed=5)
    for _ in range(7):
        np.testing.assert_array_equal(next(ours), next(ref))


def test_prefetch_loader_collates_in_order(tmp_path):
    """The loader yields the collated batches in epoch_batches' order, as
    tensors on the requested device, and stops its thread on close."""
    items = np.arange(12, dtype=np.float32)[:, None] * np.ones((1, 2), np.float32)
    loader = PrefetchLoader(items, 4, lambda xs: {"x": np.stack(xs)}, "cpu",
                            seed=3, num_workers=2)
    try:
        order = epoch_batches(12, 4, seed=3)
        for _ in range(4):
            batch = next(loader)
            assert isinstance(batch["x"], torch.Tensor)
            np.testing.assert_array_equal(batch["x"][:, 0].numpy(), next(order))
    finally:
        loader.close()
    assert not loader._feeder.is_alive()


def test_format_losses_matches_jax():
    vals = {"loss_seg1": 2.944, "loss_seg2": 1.5, "loss_D1": 0.25}
    assert format_losses(17, 250000, vals) == jax_logging.format_losses(
        17, 250000, vals)


def test_snapshot_names_and_keys(tmp_path):
    """GTA5_<step>.pth (+ _D1/_D2) in the mode subdir, with the reference's
    state-dict keys; the full-state checkpoints keep the newest three."""
    model = DeeplabMulti(device="cpu")
    d = FCDiscriminator(device="cpu")
    path = checkpoint.save_snapshot_pth(str(tmp_path), "multi_level", 5, model,
                                        d1=d, d2=d)
    assert path == str(tmp_path / "multi_level" / "GTA5_5.pth")
    assert sorted(os.listdir(tmp_path / "multi_level")) == [
        "GTA5_5.pth", "GTA5_5_D1.pth", "GTA5_5_D2.pth"]
    sd = torch.load(path, weights_only=True)
    assert set(sd) == set(model.state_dict())
    assert set(torch.load(tmp_path / "multi_level" / "GTA5_5_D1.pth",
                          weights_only=True)) == set(d.state_dict())

    class _State:
        def __init__(self):
            self.step = 0

        def state_dict(self):
            return {"step": self.step}

        def load_state_dict(self, sd):
            self.step = sd["step"]

    full = checkpoint.FullStateCheckpoints(str(tmp_path / "full"))
    state = _State()
    for step in (1, 2, 3, 4):
        state.step = step
        full.save(step, state)
    assert full.steps() == [2, 3, 4]
    fresh = _State()
    assert full.restore(fresh) and fresh.step == 4
