"""The data-parallel group's pieces on gloo ranks on the CPU, and the data
pipeline's per-process slices against the JAX package's.

`epoch_batches` with (process_index, process_count) yields JAX's slices
for the same seed, and the union of the ranks' k-th batches is the k-th
global batch. The collectives (`parallel.launch`, 2 ranks, each launch with
its own time limit): the plain and the differentiable sum, the gradient
all-reduce (one collective per module; missing gradients count as zeros;
each parameter once), the state broadcast from rank 0, the train loop's
start from rank 0's state (a full state that only rank 0's snapshot
directory holds, or rank 0's built state), and a rank that raises or hangs
failing the launch.
"""

import itertools

import numpy as np
import pytest
import torch

from adaptsegnet_tpu_torch.data.pipeline import PrefetchLoader, epoch_batches
from adaptsegnet_tpu_torch.parallel import group

LAUNCH_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_rank():
    """The ranks take one CPU thread each: the suite's workers already
    share the cores, and oversubscribed threads spin."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.mark.parametrize("n,batch,count", [(10, 2, 2), (11, 1, 2), (37, 3, 4)])
def test_epoch_batch_slices_match_jax(n, batch, count):
    # imported here: the ranks import this module, and need no JAX
    from adaptsegnet_tpu.data.pipeline import epoch_batches as jax_epoch_batches

    for index in range(count):
        ours = list(itertools.islice(epoch_batches(n, batch, 7, index, count), 12))
        ref = list(itertools.islice(jax_epoch_batches(
            n, batch, seed=7, process_index=index, process_count=count), 12))
        assert [b.tolist() for b in ours] == [b.tolist() for b in ref]


def test_rank_batches_union_is_the_global_batch():
    n, per_rank, world = 24, 2, 3
    glob_ = epoch_batches(n, per_rank * world, seed=3)
    ranks = [epoch_batches(n, per_rank, 3, r, world) for r in range(world)]
    for _ in range(3 * n // (per_rank * world)):  # three passes
        union = sorted(np.concatenate([next(it) for it in ranks]).tolist())
        assert union == sorted(next(glob_).tolist())


def test_prefetch_loader_takes_the_rank_slice():
    data = [(np.full((2,), i, np.float32),) for i in range(8)]
    collate = lambda items: {"x": np.stack([it[0] for it in items])}
    loader = PrefetchLoader(data, 2, collate, torch.device("cpu"), seed=5,
                            num_workers=1, process_index=1, process_count=2)
    try:
        got = [next(loader)["x"][:, 0].tolist() for _ in range(2)]
    finally:
        loader.close()
    ref = list(itertools.islice(epoch_batches(8, 2, 5, 1, 2), 2))
    assert got == [b.astype(np.float32).tolist() for b in ref]


def test_no_group_is_the_identity():
    t = torch.arange(3.0, requires_grad=True)
    assert not group.active() and group.rank() == 0 and group.world() == 1
    assert group.all_reduce_sum(t) is t and group.all_reduce_sum_grad(t) is t
    group.all_reduce_grads([torch.nn.Linear(2, 2)])
    group.broadcast_state(torch.nn.Linear(2, 2))


class _Net(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.a = torch.nn.Parameter(torch.randn(3, 2, generator=g))
        self.b = torch.nn.Parameter(torch.randn(4, generator=g))
        self.frozen = torch.nn.Parameter(torch.ones(2), requires_grad=False)
        self.register_buffer("stat", torch.randn(5, generator=g))


def rank_collectives():
    r = group.rank()
    x = torch.tensor([1.0, 2.0]) * (r + 1)
    plain = group.all_reduce_sum(x)
    # differentiable: y = sum_r x_r; L_r = sum(w_r * y) -> dx_r = sum_r w_r
    xg = x.clone().requires_grad_(True)
    w = torch.tensor([3.0, 5.0]) * (r + 1)
    (group.all_reduce_sum_grad(xg) * w).sum().backward()
    net = _Net(seed=10 + r)  # each rank starts from other weights
    net.a.grad = torch.full_like(net.a, float(r + 1))  # net.b: no gradient
    group.all_reduce_grads([net, None])
    grads = (net.a.grad.clone(), net.b.grad.clone(), net.frozen.grad)
    group.broadcast_state(net)
    return plain, xg.grad, grads, {k: v.clone() for k, v in net.state_dict().items()}


def test_collectives_on_two_ranks():
    (p0, g0, grads0, sd0), (p1, g1, grads1, sd1) = group.launch(
        rank_collectives, 2, cpu=True, timeout=LAUNCH_TIMEOUT_S)
    assert torch.equal(p0, torch.tensor([3.0, 6.0])) and torch.equal(p0, p1)
    assert torch.equal(g0, torch.tensor([9.0, 15.0])) and torch.equal(g0, g1)
    for grads in (grads0, grads1):
        assert torch.equal(grads[0], torch.full((3, 2), 3.0))
        assert torch.equal(grads[1], torch.zeros(4))
        assert grads[2] is None  # frozen: not reduced, not set
    ref = _Net(seed=10).state_dict()
    for k in ref:  # rank 0's weights and buffers on both ranks
        assert torch.equal(sd0[k], ref[k]) and torch.equal(sd1[k], ref[k]), k


def tiny_state(seed):
    """A TrainState of small modules: G under SGD with momentum, D1 under
    Adam, as the train loop builds them."""
    from adaptsegnet_tpu_torch.train.optim import (
        make_discriminator_optimizer, make_generator_optimizer)
    from adaptsegnet_tpu_torch.train.state import Schedule, TrainState

    model, d1 = _Net(seed), _Net(seed + 100)
    return TrainState(model=model, g_opt=make_generator_optimizer(model),
                      schedule=Schedule(), d1=d1,
                      d1_opt=make_discriminator_optimizer(d1))


def flat_state(state):
    """Every tensor of a TrainState's state dict (optimizer states
    included) under a path name, and the step."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}.{i}", x)
        elif isinstance(v, torch.Tensor):
            out[prefix] = v.detach().clone()
        elif prefix == ".step":
            out[prefix] = v
    walk("", state.state_dict())
    return out


def rank_start(dirs):
    """This rank's state after the loop's start, each rank with its own
    snapshot directory (dirs[r]) and its own built weights."""
    from adaptsegnet_tpu_torch.train.loop import _resume_or_replicate
    from adaptsegnet_tpu_torch.utils.checkpoint import FullStateCheckpoints

    r = group.rank()
    state = tiny_state(seed=10 + r)
    resumed = _resume_or_replicate(state, FullStateCheckpoints(dirs[r]),
                                   torch.device("cpu"))
    return resumed, flat_state(state)


@pytest.mark.parametrize("rank0_has_checkpoint", [True, False])
def test_ranks_start_from_rank0_state(tmp_path, rank0_has_checkpoint):
    """Rank 1 sees no checkpoint (snapshot directories not shared) and has
    no optimizer state yet; both ranks must end with rank 0's state."""
    from adaptsegnet_tpu_torch.utils.checkpoint import FullStateCheckpoints

    dirs = [str(tmp_path / "rank0"), str(tmp_path / "rank1")]
    if rank0_has_checkpoint:
        saved = tiny_state(seed=99)
        for m, opt in ((saved.model, saved.g_opt), (saved.d1, saved.d1_opt)):
            for p in m.parameters():
                if p.requires_grad:
                    p.grad = torch.ones_like(p)
            opt.step()  # momentum and Adam moments now exist
        saved.step = 5
        FullStateCheckpoints(dirs[0]).save(5, saved)
        want = flat_state(saved)
        assert any("momentum_buffer" in k for k in want)
    else:
        want = flat_state(tiny_state(seed=10))
    ranks = group.launch(rank_start, 2, cpu=True, args=(dirs,),
                         timeout=LAUNCH_TIMEOUT_S)
    for resumed, got in ranks:
        assert resumed == rank0_has_checkpoint
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], torch.Tensor):
                assert torch.equal(got[k], want[k]), k
            else:
                assert got[k] == want[k], k


def rank_fails():
    if group.rank() == 1:
        raise RuntimeError("rank 1 fails")
    return group.rank()


def rank_hangs():
    if group.rank() == 1:
        import time

        time.sleep(600)
    return group.rank()


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="rank 1 fails"):
        group.launch(rank_fails, 2, cpu=True, timeout=LAUNCH_TIMEOUT_S)


def test_a_hung_rank_times_out():
    with pytest.raises(TimeoutError):
        group.launch(rank_hangs, 2, cpu=True, timeout=10)
