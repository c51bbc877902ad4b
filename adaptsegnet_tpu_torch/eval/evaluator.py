"""Cityscapes val evaluator (reference evaluate_cityscapes.py:96-208).

Counterpart of adaptsegnet_tpu/eval/evaluator.py. Protocol: forward at
512x1024, bilinear align-corners upsample of the logits to 1024x2048 BEFORE
the argmax (reference :150-169), uint8 masks, raw-id + palette PNGs.

The tail (upsample + argmax) is chosen from the compute dtype:
  * f32 -> the exact plain tail: f32 matrix upsample (TF32 off), then
    argmax. This is the parity path, as in the JAX package.
  * bf16 with `use_kernel_tail=True` (the default) -> the fused CUDA kernel
    ops/kernels/upsample_argmax.py, which interpolates in f32 and writes
    the uint8 mask directly. The JAX package left its Pallas tail opt-in
    because XLA overlapped the plain tail inside one fused program; eager
    PyTorch has no such fusion, and its plain tail writes and re-reads an
    (N, 1024, 2048, 19) tensor. On a CPU tensor the kernel's wrapper runs
    its plain version.
  * bf16 with `use_kernel_tail=False` -> the plain bf16 tail.

A bf16 batch of two images or more also sends the backbone's layer2..layer4
3x3 convs to the hand-written batched kernel (ops/conv3x3.py, kernel 3);
batch 1 and f32 keep cuDNN. The `Evaluator` computes in f32, as the JAX one
does (adaptsegnet_tpu/eval/evaluator.py:125), so it reaches neither kernel:
`make_eval_fn(model, dtype=torch.bfloat16)` is their path.
"""

from __future__ import annotations

import collections
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from adaptsegnet_tpu_torch.eval.palette import colorize_mask
from adaptsegnet_tpu_torch.ops import precision
from adaptsegnet_tpu_torch.ops.kernels import upsample_argmax
from adaptsegnet_tpu_torch.ops.metrics import fast_hist_torch
from adaptsegnet_tpu_torch.ops.resize import upsample_logits


def make_eval_fn(
    model: nn.Module,
    out_hw: tuple[int, int] = (1024, 2048),
    output_index: int = 1,
    dtype: torch.dtype = torch.float32,
    use_kernel_tail: bool = True,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """(images NHWC on the model's device) -> uint8 masks (N, H, W).

    output_index selects pred2 of DeeplabMulti (reference :161-163); a
    single-output model (DeeplabSingle, DeeplabVGG) is not indexed.
    """
    return torch.inference_mode()(
        _make_mask_fn(model, out_hw, output_index, dtype, use_kernel_tail))


def _make_mask_fn(model, out_hw, output_index, dtype, use_kernel_tail):
    """The single eval forward body shared by make_eval_fn and
    make_eval_hist_fn, so the two paths cannot drift."""
    precision.configure(dtype)
    exact = dtype == torch.float32
    use_kernel = use_kernel_tail and not exact

    def mask_fn(images: torch.Tensor) -> torch.Tensor:
        preds = model(images.to(dtype))
        pred = preds[output_index] if isinstance(preds, (tuple, list)) else preds
        if use_kernel:
            return upsample_argmax(pred.contiguous(), out_hw)
        up = upsample_logits(pred, out_hw, exact=exact)
        return up.argmax(dim=-1).to(torch.uint8)

    return mask_fn


def make_eval_hist_fn(
    model: nn.Module,
    out_hw: tuple[int, int] = (1024, 2048),
    output_index: int = 1,
    num_classes: int = 19,
    dtype: torch.dtype = torch.float32,
    use_kernel_tail: bool = True,
) -> Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """(images, labels) -> (masks uint8, hist int64 on the device).

    Labels are train ids at out_hw resolution; out-of-range ids (255
    ignore, padding) contribute nothing.
    """
    mask_fn = _make_mask_fn(model, out_hw, output_index, dtype,
                            use_kernel_tail)

    @torch.inference_mode()
    def eval_hist_fn(images, labels):
        masks = mask_fn(images)
        return masks, fast_hist_torch(labels, masks, num_classes)

    return eval_hist_fn


class Evaluator:
    """Streams a CityscapesDataset through the eval fn, writing PNGs.

    `save_dir=None` skips PNG output; `run_streaming` accumulates the
    confusion matrix on the device instead.

    `mesh`, a `torch.distributed` process group (e.g.
    `torch.distributed.group.WORLD`), makes the eval data-parallel, as the
    JAX Evaluator's mesh does (adaptsegnet_tpu/eval/evaluator.py:109-154):
    each of its W ranks takes the interleaved slice of the dataset (items
    rank, rank + W, ...) at a local batch of batch_size / W, so that the
    ranks' k-th batches together are the k-th global batch, and writes its
    own PNGs; `run_streaming` sums the histogram over the group. A batch
    that does not divide by W raises.
    """

    def __init__(
        self,
        model: nn.Module,
        out_hw: tuple[int, int] = (1024, 2048),
        output_index: int = 1,
        save_dir: Optional[str] = None,
        mesh=None,
        num_classes: int = 19,
    ):
        self.mesh = mesh
        self.eval_fn = make_eval_fn(model, out_hw=out_hw,
                                    output_index=output_index)
        self._model = model
        self._device = next(model.parameters()).device
        self._out_hw = out_hw
        self._output_index = output_index
        self._num_classes = num_classes
        self._hist_fn = None  # built lazily by run_streaming
        self.save_dir = save_dir
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    def _local(self, ds, batch_size):
        """(this rank's view of `ds`, its local batch, its rank, the
        group's size)."""
        if self.mesh is None:
            return ds, batch_size, 0, 1
        import torch.distributed as dist

        w = dist.get_world_size(self.mesh)
        if batch_size % w:
            raise ValueError(f"eval batch {batch_size} not divisible by the "
                             f"{w}-process group")
        r = dist.get_rank(self.mesh)
        return _Strided(ds, r, w), batch_size // w, r, w

    def _stream(self, ds, batch_size, num_workers, progress_every, stacked,
                pad_value, step) -> list[str]:
        """Shared streaming skeleton for run / run_streaming.

        Host work overlaps device work: a thread pool decodes items ahead of
        the device (in place of the JAX package's PrefetchIterator) while
        PNG encodes trail behind on another. The ragged tail (n % batch_size
        items) is padded to the full batch so every forward has one shape,
        and the padded masks are dropped.

        stacked: item columns stacked into device tensors (others stay
        lists); pad_value(col, last) -> padding element for a stacked
        column; step(cols) -> masks for the batch. Returns written PNG paths
        (this rank's, in a group).
        """
        ds, batch_size, rank, w = self._local(ds, batch_size)
        lead = rank == 0
        n = len(ds)
        lookahead = 2 * batch_size + num_workers
        futures = []
        with ThreadPoolExecutor(max(1, num_workers)) as loader, \
                ThreadPoolExecutor(2) as writer:
            pending = collections.deque()
            next_item = 0
            for start in range(0, n, batch_size):
                while next_item < n and len(pending) < lookahead:
                    pending.append(loader.submit(ds.__getitem__, next_item))
                    next_item += 1
                k = min(batch_size, n - start)
                items = [pending.popleft().result() for _ in range(k)]
                cols = []
                for col in range(len(items[0])):
                    vals = [item[col] for item in items]
                    if col in stacked:
                        vals += [pad_value(col, vals[-1])] * (batch_size - k)
                        vals = torch.from_numpy(np.stack(vals)).to(self._device)
                    cols.append(vals)
                masks = step(cols)[:k].cpu().numpy()
                if lead and start % (progress_every * batch_size) == 0:
                    print(f"{start * w} processd")  # reference log line (:157)
                if self.save_dir:
                    for mask, name in zip(masks, cols[-1]):
                        futures.append(writer.submit(self._save_mask, mask, name))
            return [f.result() for f in futures]

    def run(self, dataset, batch_size: int = 1, progress_every: int = 100,
            num_workers: int = 4) -> list[str]:
        """Evaluate every image; returns the list of written PNG paths."""
        return self._stream(
            dataset, batch_size, num_workers, progress_every,
            stacked={0},
            pad_value=lambda col, last: last,
            step=lambda cols: self.eval_fn(cols[0]),
        )

    def run_streaming(
        self,
        dataset,
        gt_loader: Callable[[str], np.ndarray],
        batch_size: int = 1,
        num_workers: int = 4,
        progress_every: int = 100,
    ) -> np.ndarray:
        """PNG-free streaming mIoU: returns the accumulated confusion matrix.

        `gt_loader(name) -> (H, W) int train-id label` at the evaluator's
        output resolution. The hist accumulates on the device in int64;
        padded ragged-tail items carry all-ignore (255) labels. PNGs are
        still written when save_dir is set. In a group every rank returns
        the histogram summed over the group.
        """
        if self._hist_fn is None:
            self._hist_fn = make_eval_hist_fn(
                self._model, out_hw=self._out_hw,
                output_index=self._output_index,
                num_classes=self._num_classes,
            )
        hist = torch.zeros((self._num_classes, self._num_classes),
                           dtype=torch.int64, device=self._device)

        class _WithLabels:
            """Dataset adapter: item -> (image, label, name)."""

            def __init__(self, ds):
                self._ds = ds

            def __len__(self):
                return len(self._ds)

            def __getitem__(self, i):
                item = self._ds[i]
                return item[0], gt_loader(item[-1]).astype(np.int64), item[-1]

        def step(cols):
            masks, h = self._hist_fn(cols[0], cols[1])
            hist.add_(h)
            return masks

        self._stream(
            _WithLabels(dataset), batch_size, num_workers, progress_every,
            stacked={0, 1},
            pad_value=lambda col, last: (
                last if col == 0 else np.full_like(last, 255)
            ),
            step=step,
        )
        if self.mesh is not None:
            import torch.distributed as dist

            dist.all_reduce(hist, group=self.mesh)
        return hist.cpu().numpy()

    def _save_mask(self, mask, name):
        from PIL import Image

        base = name.split("/")[-1]
        out = osp.join(self.save_dir, base)
        Image.fromarray(np.asarray(mask)).save(out)
        colorize_mask(np.asarray(mask)).save(
            osp.join(self.save_dir, base.split(".")[0] + "_color.png")
        )
        return out


class _Strided:
    """Items rank, rank + w, rank + 2w, ... of a map-style dataset."""

    def __init__(self, ds, rank: int, w: int):
        self._ds, self._rank, self._w = ds, rank, w

    def __len__(self):
        return len(range(self._rank, len(self._ds), self._w))

    def __getitem__(self, i):
        return self._ds[self._rank + i * self._w]
