"""One run of a cell: set-up, the checked steps, the window, the reading of
the trace, and the comparison with the plain reference.

Train: the benchmark makes the weights and a pool of batches from the
seed, builds the program's train state and step and loads the weights,
drives that same state through the first `checked_steps` steps with the
window's own call and batches (all different), reading the losses, the
first gradient from the optimizers' states and, before the window, each
parameter's change. The window then runs the same object on. Once it has
closed and the memory peak is read, the program is freed and the
reference follows the same steps from the same weights and batches.

Eval: the program's bf16 eval function over the benchmark's weights,
warmed on the pool, then the window; the reference checks the masks and
histograms of the last call on each batch of the pool.

In a cell of several cards each rank (one process per card, through the
program's `parallel/group.py::launch`) runs the set-up and the window on
its share of each global batch; the parent touches no card until the
ranks have ended, then runs the reference on card 0 over the global batch.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.lib import inputs, program, registry, trace, window
from benchmark.lib.peaks import least_seconds
from benchmark.reference import evaluate as ref_eval
from benchmark.reference.numerics import Numerics, strict_f32
from benchmark.reference.train import ReferenceTrainer


class HarnessError(RuntimeError):
    """A run that cannot report: it prints no result and exits nonzero."""


def _host(weights: dict) -> dict:
    return {m: {k: v.detach().cpu() for k, v in sd.items()}
            for m, sd in weights.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- the trace


def _check_counts(plan: dict, calls: int, counts: dict, fams: dict,
                  families: dict) -> None:
    """The wrappers' launches against the work table, and the profiler's
    records of each family against the wrappers' launches."""
    for wrapper, n in counts.items():
        want = calls * plan["launches"].get(wrapper, 0)
        if n != want:
            raise HarnessError(
                f"{wrapper} launched {n} times in {calls} calls, the work "
                f"table expects {want}: the program's path has changed and "
                "the benchmark's work table must follow it")
    for fam, module in families.items():
        launched = sum(counts.get(w, 0) for w in module.WRAPPERS)
        if fams[fam]["records"] != launched:
            raise HarnessError(
                f"the trace holds {fams[fam]['records']} records of "
                f"{fam}'s kernels, its wrappers launched {launched}: the "
                "profiler lost records, so this window cannot be read")


def read_trace(prof, win: dict, plan: dict, counts: dict, device) -> dict:
    prof.stop()
    families = registry.families()
    index = torch.device(device).index or 0
    events = trace.device_events(prof, index)
    t0, t1 = win["t0"], win["t1"]
    fams = trace.by_family(events, families)
    _check_counts(plan, win["calls"], counts, fams, families)
    least = {f: 0.0 for f in families}
    owner = {w: f for f, m in families.items() for w in m.WRAPPERS}
    for wrapper, launch in plan["items"]:
        fam = owner[wrapper]
        ops, nbytes = families[fam].work(launch)
        least[fam] += least_seconds(ops, nbytes, families[fam].PEAK)
    return {
        "busy_s": trace.union_ns(events, t0, t1) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "families": {f: {"seconds": v["seconds"],
                         "least_s": least[f] * win["calls"]}
                     for f, v in fams.items()},
        "device_ops": trace.top_ops(events),
        "idle_gaps": trace.idle_gaps(events, t0, t1, win["spans"]),
    }


def _traced(tracing: bool, device) -> bool:
    """The device trace exists on a card only; a CPU run (the benchmark's
    tests) reads no device metric."""
    return tracing and torch.device(device).type == "cuda"


def _window_summary(win: dict) -> dict:
    return {k: win[k] for k in ("t0", "t1", "calls", "images", "enqueue_ms",
                                "call_ms")}


# ----------------------------------------------------------------- training


def train_setup(spec: dict, seed: int, device, wrap_step=None, group=None):
    """The program's state and step from the seed's weights, driven through
    the checked steps: (state, step, batches, readings); in a group, on
    this rank's share of each global batch."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    rank = group.rank() if group is not None else 0
    n, cards = traffic["batch_per_card"], traffic.get("cards", 1)
    part = slice(rank * n, (rank + 1) * n) if cards > 1 else None
    weights = inputs.make_weights(cfg, seed, device)
    start = _host(weights)
    state, step = program.build_train(cfg, seed, weights, device, n * cards)
    del weights
    batches = [program.step_batch(b) for b in
               inputs.make_pool(cfg, traffic, seed, device, part)]
    if wrap_step is not None:
        step = wrap_step(step, state)
    readings = {"losses": []}
    for k in range(traffic["checked_steps"]):
        metrics = step(state, batches[k])
        readings["losses"].append({m: float(v) for m, v in metrics.items()})
        if k == 0:
            readings["grads"] = program.first_gradients(state, start, cfg)
    readings["changes"] = program.changes(state, start)
    readings["stats"] = program.warper_stats(state, start)
    _sync(device)
    return state, step, batches, (readings if rank == 0 else None)


def program_train(spec: dict, seed: int, seconds: float, tracing: bool,
                  device, started: float, wrap_step=None, group=None) -> dict:
    """The program's side of a train run on this process's card."""
    state, step, batches, readings = train_setup(spec, seed, device,
                                                 wrap_step, group)
    setup_s = time.time() - started
    program.reset_launches()
    prof = trace.start() if _traced(tracing, device) else None
    traffic = spec["traffic"]
    win = window.train(state, step, batches, seconds,
                       traffic["batch_per_card"] * traffic.get("cards", 1),
                       group)
    counts = program.launches()
    out = {"setup_s": setup_s, "window": _window_summary(win),
           "failed": win["failed"], "peak": _peak(device),
           "readings": readings}
    if prof is not None:
        out["trace"] = read_trace(prof, win, spec["plan"], counts, device)
    del state, step, batches
    _free(device)
    return out


def reference_train(cfg: dict, traffic: dict, seed: int, device, fp8=False,
                    fault: str | None = None) -> dict:
    """The reference's readings over the first checked steps, from the
    seed's weights and global batches. `fp8` makes it the control; `fault`
    plants one of the faults the comparison must catch: 'half' (each step
    on the first half of its batch, the mean over those images) or
    'd1_split' (D1's loss, and so its weight gradient, summed over the
    first half of the batch alone but over the whole batch's count, as a
    weight gradient that loses a split)."""
    weights = inputs.make_weights(cfg, seed, device)
    start = _host(weights)
    pool = inputs.make_pool(cfg, traffic, seed, device)
    ref = ReferenceTrainer(cfg, weights, device, Numerics(fp8=fp8))
    del weights
    out = {"losses": []}
    with strict_f32():
        for k in range(traffic["checked_steps"]):
            batch = pool[k]
            if fault == "half":
                batch = {key: v[:v.shape[0] // 2] for key, v in batch.items()}
            out["losses"].append(ref.step(batch, d1_split=fault == "d1_split"))
            if k == 0:
                out["grads"] = {m: {n: p.grad.detach().float().cpu()
                                    for n, p in mod.named_parameters()
                                    if p.requires_grad}
                                for m, mod in ref.modules().items()}
    with torch.no_grad():
        out["changes"] = {m: {n: float(torch.linalg.vector_norm(
            p - start[m][n].to(p.device))) for n, p in mod.named_parameters()
            if p.requires_grad} for m, mod in ref.modules().items()}
        out["stats"] = ({} if ref.warper is None else
                        {n: float(torch.linalg.vector_norm(
                            b - start["W"][n].to(b.device)))
                         for n, b in ref.warper.named_buffers()})
    del ref, pool
    _free(device)
    return out


# ----------------------------------------------------------------- evaluation


def program_eval(spec: dict, seed: int, seconds: float, tracing: bool,
                 device, started: float, wrap_eval=None) -> dict:
    cfg, traffic, plan = spec["cfg"], spec["traffic"], spec["plan"]
    weights = inputs.make_weights(cfg, seed, device)
    model, fn = program.build_eval(cfg, weights, device)
    del weights
    pool = inputs.make_pool(cfg, traffic, seed, device)
    if wrap_eval is not None:
        fn = wrap_eval(fn)
    for batch in pool[:2]:  # every call has one shape
        fn(batch["images"], batch["labels"])
    _sync(device)
    setup_s = time.time() - started
    program.reset_launches()
    prof = trace.start() if _traced(tracing, device) else None
    win = window.evaluate(fn, pool, seconds, cfg["num_classes"],
                          traffic["batch_per_card"])
    counts = program.launches()
    out = {"setup_s": setup_s, "window": _window_summary(win), "failed": 0,
           "peak": _peak(device),
           "kept": {i: (m.cpu(), h.cpu()) for i, (m, h) in win["kept"].items()}}
    if prof is not None:
        out["trace"] = read_trace(prof, win, plan, counts, device)
    del model, fn, win
    _free(device)
    return out, pool


def reference_eval(cfg: dict, seed: int, pool: list, kept: dict, device,
                   fp8: bool = False) -> dict:
    """mask_gap and hist_mismatch of the kept calls. With fp8 the masks
    judged are the fp8 reference's own (the control)."""
    from benchmark.reference import models

    weights = inputs.make_weights(cfg, seed, device)
    g = models.DeeplabMulti(cfg, Numerics(), device)
    g.load_state_dict(weights["G"])
    control = None
    if fp8:
        control = models.DeeplabMulti(cfg, Numerics(fp8=True), device)
        control.load_state_dict(weights["G"])
    del weights
    out_hw = tuple(cfg["eval_output_size"])
    gap, mismatch = 0.0, 0
    with strict_f32():
        for i, batch in enumerate(pool):
            if i not in kept:
                continue
            masks, hist = kept[i]
            if control is not None:
                masks = torch.stack([up.argmax(0).to(torch.uint8) for _, up in
                                     ref_eval.upsampled_logits(
                                         control, batch["images"], out_hw)])
                hist = ref_eval.confusion(batch["labels"].cpu(), masks.cpu(),
                                          cfg["num_classes"])
            for j, up in ref_eval.upsampled_logits(g, batch["images"], out_hw):
                gap = max(gap, ref_eval.mask_gap(up, masks[j].to(up.device)))
            want = ref_eval.confusion(batch["labels"].cpu(), masks.cpu(),
                                      cfg["num_classes"])
            mismatch += int((want != hist.cpu()).sum())
    del g, control
    _free(device)
    return {"mask_gap": gap, "hist_mismatch": float(mismatch)}
