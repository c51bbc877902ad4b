"""Faults planted in the timed path by the benchmark's tests: each must
make a run's `correct` false. A fault wraps the program's step (train) or
eval function; module-level functions, so that the ranks of a group can
take them."""

from __future__ import annotations

import torch


def state_unchanged(step, state):
    """The step computes as usual but leaves the parameters as they were."""
    def broken(st, batch, *extra):
        before = {n: p.detach().clone() for m in (st.model, st.d1, st.d2)
                  if m is not None for n, p in m.named_parameters(prefix=str(id(m)))}
        out = step(st, batch, *extra)
        with torch.no_grad():
            for m in (st.model, st.d1, st.d2):
                if m is not None:
                    for n, p in m.named_parameters(prefix=str(id(m))):
                        p.copy_(before[n])
        return out
    return broken


def half_batch(step, state):
    """The step sees the first half of its batch: the mean over the rest."""
    def broken(st, batch, *extra):
        half = {k: v[:, :v.shape[1] // 2] for k, v in batch.items()}
        return step(st, half, *extra)
    return broken


def no_exchange(step, state):
    """The gradients are never summed over the group's ranks."""
    from adaptsegnet_tpu_torch.parallel import group
    group.all_reduce_grads = lambda modules: None
    return step


def answer_altered(fn):
    """One pixel of every mask takes the next class where it is produced."""
    def broken(images, labels):
        masks, hist = fn(images, labels)
        masks = masks.clone()
        masks[:, 0, 0] = (masks[:, 0, 0] + 1) % 19
        return masks, hist
    return broken
