"""The numbers that decide `correct`, and their limits.

Training (the run's first three steps, program against the reference on
the same weights and batches):
* `loss_gap`: the largest relative gap of a loss, over the losses and the
  three steps;
* `seg_gap`: the same over the first step's segmentation losses alone
  (`loss_seg1`, `loss_seg2`): the forward's precision, before any update
  and without the adversarial losses' small values;
* `grad_gap`: the first step's gradient as each optimizer got it, read
  from its state after that step (SGD's momentum buffer less the weight
  decay, Adam's first moment over 1 - beta1); per module, the worst leaf's
  gap between the program's norm and the reference's, over the larger of
  the reference's norm of that leaf and of the module's median leaf;
* `grad_dev`: the same first gradient, element by element: per module,
  the norm of the program's gradient less the reference's over the norm
  of the reference's, all of the module's leaves together; the largest
  over the modules, each also apart (`grad_dev.G`, `grad_dev.D1`, ...).
  Unlike a gap of norms it reads the gradient's direction, so a gradient
  taken over part of the batch reads apart from rounding;
* `change_gap`: the same for each parameter's change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the module's median leaf (they move by round-off and decay alone);
* `stats_gap`: the same for the change of the Warper's BatchNorm running
  statistics (its cell only).

Evaluation (the last call on each batch of the pool):
* `mask_gap`: the widest gap by which the reference logit of a pixel's
  class in the program's mask lies below the reference's largest, as a
  share of the image's largest logit magnitude;
* `hist_mismatch`: the entries in which the program's histogram differs
  from the confusion matrix of its own masks (limit 0).
"""

from __future__ import annotations

import statistics

import torch


def leaf_gaps(prog: dict, ref: dict, leave_out=()) -> list:
    """Per leaf |prog - ref| / max(ref, median of ref); a leaf the program
    lacks reads as 0."""
    med = statistics.median(ref[k] for k in ref)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if k not in leave_out] or [0.0]


def worst_gap(prog: dict, ref: dict, leave_out=()) -> float:
    return max(leaf_gaps(prog, ref, leave_out))


def median_gap(prog: dict, ref: dict, leave_out=()) -> float:
    return statistics.median(leaf_gaps(prog, ref, leave_out))


def negligible(ref_grads: dict) -> set:
    """Leaves whose reference gradient is under a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v < 1e-3 * med}


def loss_gap(prog_losses: list, ref_losses: list) -> float:
    worst = 0.0
    for p, r in zip(prog_losses, ref_losses):
        for k, rv in r.items():
            worst = max(worst, abs(p[k] - rv) / max(abs(rv), 1e-12))
    return worst


def deviation(prog: dict, ref: dict) -> float:
    """||prog - ref|| / ||ref|| over all the leaves of `ref` ({leaf:
    tensor}); a leaf the program lacks counts whole."""
    num = den = 0.0
    for k, r in ref.items():
        den += float(torch.linalg.vector_norm(r)) ** 2
        num += float(torch.linalg.vector_norm(
            prog[k] - r if k in prog else r)) ** 2
    return (num / max(den, 1e-300)) ** 0.5


def _norms(grads: dict) -> dict:
    return {m: {k: float(torch.linalg.vector_norm(v)) for k, v in g.items()}
            for m, g in grads.items()}


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog and ref: {'losses': [per step {name: value}], 'grads': {module:
    {leaf: first gradient}}, 'changes': {module: {leaf: norm}}, 'stats':
    {leaf: norm} or absent}. Besides the numbers above, the median leaf's
    gap per module, the largest over the modules (`grad_gap_med`,
    `change_gap_med`), which calibrate.py reads beside the worst leaf's."""
    seg = [{k: v for k, v in step.items() if k.startswith("loss_seg")}
           for step in ref["losses"][:1]]
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "seg_gap": loss_gap(prog["losses"][:1], seg)}
    prog_norms, ref_norms = _norms(prog["grads"]), _norms(ref["grads"])
    for name, fn in (("", worst_gap), ("_med", median_gap)):
        out["grad_gap" + name] = max(fn(prog_norms.get(m, {}), g)
                                     for m, g in ref_norms.items())
        out["change_gap" + name] = max(
            fn(prog["changes"].get(m, {}), c, negligible(ref_norms[m]))
            for m, c in ref["changes"].items())
    devs = {m: deviation(prog["grads"].get(m, {}), g)
            for m, g in ref["grads"].items()}
    out["grad_dev"] = max(devs.values())
    out.update({f"grad_dev.{m}": v for m, v in devs.items()})
    if ref.get("stats"):
        out["stats_gap"] = worst_gap(prog["stats"], ref["stats"])
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number present, finite and within its limit (a limit not set
    yet, null, passes nothing)."""
    return all(limits[k] is not None and numbers.get(k) is not None
               and numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)
