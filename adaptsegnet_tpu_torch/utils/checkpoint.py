"""Snapshots: reference-layout .pth files and full-state resume.

Counterpart of adaptsegnet_tpu/utils/checkpoint.py:
  * `save_snapshot_pth` keeps the external contract: GTA5_<step>.pth (+
    GTA5_<step>_D1.pth / _D2.pth) in <snapshot_dir>/<mode subdir>, with the
    reference's state-dict keys, loadable by the evaluate CLIs of both
    packages and by the reference;
  * `FullStateCheckpoints` saves the whole TrainState (weights, optimizer
    states, step) with torch.save, keeps the newest `max_to_keep`, and
    restores the latest for exact resume. It stands where the JAX package's
    orbax CheckpointManager stands, behind the same --orbax-checkpoints flag.
"""

from __future__ import annotations

import io
import os
import os.path as osp
import re

import torch

from adaptsegnet_tpu_torch.utils import pth_interop


def save_snapshot_pth(snapshot_dir: str, mode_subdir: str, step: int, model,
                      d1=None, d2=None) -> str:
    """Write GTA5_<step>.pth (+ _D1/_D2); returns the generator's path."""
    out_dir = osp.join(snapshot_dir, mode_subdir)
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, f"GTA5_{step}.pth")
    pth_interop.save_torch_state_dict(model.state_dict(), path)
    for tag, d in (("D1", d1), ("D2", d2)):
        if d is not None:
            pth_interop.save_torch_state_dict(
                d.state_dict(), osp.join(out_dir, f"GTA5_{step}_{tag}.pth"))
    return path


class FullStateCheckpoints:
    _NAME = re.compile(r"^state_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = osp.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := self._NAME.match(f)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return osp.join(self.directory, f"state_{step}.pt")

    def save(self, step: int, state) -> None:
        path = self.path(step)
        torch.save(state.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, state, step: int | None = None) -> bool:
        step = self.latest_step() if step is None else step
        if step is None:
            return False
        with open(self.path(step), "rb") as f:
            self.load_bytes(state, f.read())
        return True

    def read_latest(self) -> bytes | None:
        """The newest saved state's file as bytes; None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        with open(self.path(step), "rb") as f:
            return f.read()

    @staticmethod
    def load_bytes(state, data: bytes) -> None:
        """Load a saved state's file, given as bytes, into `state`."""
        state.load_state_dict(torch.load(io.BytesIO(data), map_location="cpu",
                                         weights_only=False))
