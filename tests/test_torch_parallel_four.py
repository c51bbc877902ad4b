"""Data parallelism on a group of 4 gloo ranks on the CPU: what two ranks
(tests/test_torch_parallel_steps.py, test_torch_parallel_eval.py) cannot
show.

One launch of 4 ranks (`parallel.launch`, cpu=True, with a time limit) runs
every step case and the eval. The steps, each one step from the twin states
of tests/test_torch_train_steps.py, test_torch_warper_steps.py and
test_torch_train_flags.py, on a global batch of 4 (one image per rank), held
against the JAX step on the same global batch and against the port in one
process at rtol 1e-4 / atol 1e-5 (tests/test_parallel.py:45-51):
  * a batch in which rank 2's whole slice is the ignore label and rank 0's
    is 90 % ignored (the cross-entropy's mean is over the global count);
  * interleaved slices at a global batch of 8: rank r takes images r and
    r + 4;
  * `bn_mode='batch'` statistics summed over four one-image ranks;
  * the Warper's batch-norm statistics over four one-image ranks.
The four ranks hold bit-identical states after the step. The eval:
`Evaluator.run_streaming` at a global batch of 4 over 7 images (a ragged
tail; rank r takes images r, r + 4) equals one process at batch 1 in its
histogram and every PNG. Last, a rank that raises while the other three wait
in a collective fails the launch at once, not at its time limit, and a
launch of more CUDA ranks than cards raises before any rank starts.
"""

import copy
import io
import os
import os.path as osp

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

import jax.numpy as jnp

from adaptsegnet_tpu.data.pipeline import epoch_batches as jax_epoch_batches
from adaptsegnet_tpu.train.steps import (
    make_adversarial_step as jax_adversarial_step,
    make_source_only_step as jax_source_only_step,
)
from adaptsegnet_tpu_torch.data import CityscapesDataset, lists
from adaptsegnet_tpu_torch.data.pipeline import PrefetchLoader
from adaptsegnet_tpu_torch.parallel import group
from tests import test_torch_parallel_eval as peval
from tests import test_torch_parallel_steps as psteps
from tests import test_torch_train_flags as flags
from tests import test_torch_train_steps as tsteps
from tests import test_torch_warper_steps as wsteps

RANKS = 4
LAUNCH_TIMEOUT_S = 300
CASES = ("multi-level-ignore", "interleaved-8", "bn-batch",
         "source-only-warper")
N_IMAGES = 7  # eval: a ragged tail at a global batch of 4


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_rank():
    """The ranks take one CPU thread each: the suite's workers already
    share the cores, and oversubscribed threads spin."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _batch(rng, n, hw):
    batch = {
        "images": rng.standard_normal((1, n, *hw, 3)).astype(np.float32),
        "labels": rng.integers(0, tsteps.C, size=(1, n, *hw)),
        "target_images": rng.standard_normal((1, n, *hw, 3)).astype(np.float32),
    }
    batch["labels"][..., :3] = 255
    return batch


def build_case(name, rng):
    """(JAX state, JAX step, port state, port step spec, global batch,
    seg_sd), as tests/test_torch_parallel_steps.py::build_case."""
    seg_sd = psteps._seg_sd
    if name == "bn-batch":
        jseg, disc, jstate, state = psteps._bn_batch_case(rng)
        seg_sd = psteps._bn_seg_sd
        jstep = jax_adversarial_step(jseg, disc, level="multi-level",
                                     input_hw=flags.HW, donate=False)
        spec = ("adv", dict(level="multi-level", input_hw=flags.HW))
        batch = _batch(rng, RANKS, flags.HW)
    elif name == "source-only-warper":
        _, jstate, state = tsteps.twin_states(rng, multi=False, with_d=False)
        jw, jstate, _ = wsteps.add_warper(jstate, state)
        jstep = jax_source_only_step(tsteps.JaxTinySeg(), warper_module=jw,
                                     input_hw=wsteps.HW, donate=False)
        spec = ("src", dict(input_hw=wsteps.HW))
        batch = _batch(rng, RANKS, wsteps.HW)
        del batch["target_images"]
    else:
        disc, jstate, state = tsteps.twin_states(rng, multi=True)
        jstep = jax_adversarial_step(tsteps.JaxTinySeg(), disc,
                                     level="multi-level", input_hw=tsteps.HW,
                                     donate=False)
        spec = ("adv", dict(level="multi-level", input_hw=tsteps.HW))
        n = 2 * RANKS if name == "interleaved-8" else RANKS
        batch = _batch(rng, n, tsteps.HW)
        if name == "multi-level-ignore":
            labels = batch["labels"][0]
            labels[2] = 255  # rank 2's whole slice
            labels[0][rng.random(labels.shape[1:]) < 0.9] = 255
    return jstate, jstep, state, spec, batch, seg_sd


def rank_eval(ckpt, root, list_path, gts, save_dir):
    """This rank's run_streaming at a global batch of 4, its image names
    and local batch."""
    ev = peval.evaluator(ckpt, save_dir, mesh=dist.group.WORLD)
    ds = CityscapesDataset(root, list_path, crop_size=peval.IN_HW[::-1])
    hist = ev.run_streaming(ds, gts.__getitem__, batch_size=RANKS,
                            num_workers=1)
    view, local_batch, r, _ = ev._local(ds, RANKS)
    return hist, [view[i][-1] for i in range(len(view))], local_batch, r


def rank_run(payload, eval_args):
    return psteps.rank_steps(payload), rank_eval(*eval_args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(4096)
    built = {name: build_case(name, rng) for name in CASES}
    buf = io.BytesIO()
    torch.save({name: (copy.deepcopy(c[2]), c[3], c[4])
                for name, c in built.items()}, buf)

    tmp = tmp_path_factory.mktemp("dp_four")
    root = str(tmp / "cs")
    list_path = lists.make_synthetic_cityscapes(root, "val", n=N_IMAGES,
                                                size_wh=peval.IN_HW[::-1])
    ckpt = str(tmp / "m.pth")
    peval.checkpoint(ckpt)
    ds = CityscapesDataset(root, list_path, crop_size=peval.IN_HW[::-1])
    gts = {}
    for i in range(N_IMAGES):
        label = rng.integers(0, 19, peval.OUT_HW)
        label[rng.random(peval.OUT_HW) < 0.2] = 255
        gts[ds[i][2]] = label
    one_dir, four_dir = str(tmp / "one"), str(tmp / "four")
    hist_one = peval.evaluator(ckpt, one_dir).run_streaming(
        ds, gts.__getitem__, batch_size=1, num_workers=1)

    ranks = group.launch(rank_run, RANKS, cpu=True,
                         args=(buf.getvalue(),
                               (ckpt, root, list_path, gts, four_dir)),
                         timeout=LAUNCH_TIMEOUT_S)
    steps = {}
    for name, (jstate, jstep, state, spec, batch, seg_sd) in built.items():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics = psteps._make_step(spec)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        steps[name] = {
            "jax": ({k: float(v) for k, v in jm.items()},
                    psteps._jax_sds(jstate, seg_sd)),
            "one": ({k: float(v) for k, v in metrics.items()},
                    psteps._port_sds(state)),
            "ranks": [r[0][name] for r in ranks],
        }
    evals = {"hist_one": hist_one, "ranks": [r[1] for r in ranks],
             "one_dir": one_dir, "four_dir": four_dir, "gts": gts}
    return steps, evals


@pytest.mark.parametrize("case", CASES)
def test_four_rank_step_matches_jax(runs, case):
    psteps._assert_close(runs[0][case]["ranks"][0], runs[0][case]["jax"],
                         f"{case} vs JAX")


@pytest.mark.parametrize("case", CASES)
def test_four_rank_step_matches_one_process(runs, case):
    psteps._assert_close(runs[0][case]["ranks"][0], runs[0][case]["one"],
                         f"{case} vs 1 process")


@pytest.mark.parametrize("case", CASES)
def test_four_ranks_hold_identical_states(runs, case):
    (m0, sd0), *others = runs[0][case]["ranks"]
    for r, (m, sd) in enumerate(others, 1):
        assert m == m0, (case, r)
        for mod, tensors in sd0.items():
            for k, v in tensors.items():
                assert torch.equal(v, sd[mod][k]), (case, r, mod, k)


def test_eval_four_ranks_histogram_equals_one_process(runs):
    evals = runs[1]
    assert evals["hist_one"].sum() > 0
    valid = sum(int((label != 255).sum()) for label in evals["gts"].values())
    assert evals["hist_one"].sum() == valid
    for hist, *_ in evals["ranks"]:  # every rank holds the global histogram
        np.testing.assert_array_equal(hist, evals["hist_one"])


def test_eval_four_ranks_pngs_equal_one_process(runs):
    evals = runs[1]
    names = sorted(os.listdir(evals["one_dir"]))
    assert len(names) == 2 * N_IMAGES  # raw ids + palette
    assert sorted(os.listdir(evals["four_dir"])) == names
    for name in names:
        np.testing.assert_array_equal(
            np.array(Image.open(osp.join(evals["four_dir"], name))),
            np.array(Image.open(osp.join(evals["one_dir"], name))),
            err_msg=name)


def test_eval_ranks_take_interleaved_slices(runs):
    """Rank r takes images r and r + 4 at a local batch of 1; rank 3 has
    one image and ranks 0-2 pad nothing."""
    evals = runs[1]
    names = list(evals["gts"])
    got = [(r, view, local) for _, view, local, r in evals["ranks"]]
    assert got == [(r, names[r::RANKS], 1) for r in range(RANKS)]


def test_prefetch_loader_takes_the_rank_slice_of_four():
    data = [(np.full((2,), i, np.float32),) for i in range(11)]
    collate = lambda items: {"x": np.stack([it[0] for it in items])}
    for r in range(RANKS):
        loader = PrefetchLoader(data, 2, collate, torch.device("cpu"), seed=5,
                                num_workers=1, process_index=r,
                                process_count=RANKS)
        try:
            got = [next(loader)["x"][:, 0].tolist() for _ in range(3)]
        finally:
            loader.close()
        ref = [next(it).tolist() for it in [jax_epoch_batches(
            11, 2, seed=5, process_index=r, process_count=RANKS)]
            for _ in range(3)]
        assert got == [[float(i) for i in b] for b in ref], r


def rank_fails_mid_collective():
    if group.rank() == 3:
        raise RuntimeError("rank 3 fails")
    group.all_reduce_sum(torch.ones(1))  # waits on rank 3, which never comes
    return group.rank()


def test_a_rank_failing_while_the_others_wait_fails_the_launch():
    """The launch fails with rank 3's error, not at its time limit
    (TimeoutError) nor at the group's (GROUP_TIMEOUT_S)."""
    with pytest.raises(Exception, match="rank 3 fails"):
        group.launch(rank_fails_mid_collective, RANKS, cpu=True,
                     timeout=LAUNCH_TIMEOUT_S)


def test_launch_needs_a_card_per_rank(monkeypatch):
    """More CUDA ranks than visible cards raise in the caller, before any
    rank starts (a rank would fail in torch.cuda.set_device)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="4 ranks need 4 CUDA cards, 1 visible"):
        group.launch(rank_fails_mid_collective, RANKS)
