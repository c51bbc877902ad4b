"""Data-parallel process groups: the port's counterpart of the JAX mesh.

Counterpart of adaptsegnet_tpu/parallel/mesh.py. The JAX package runs one
process over a 1-D device mesh, shards the global batch on its 'data' axis
and lets GSPMD make every batch reduction global. The port runs one process
per device in a `torch.distributed` group (NCCL on the card, gloo on the
CPU): a rank holds B / W images of a global batch of B, and the train steps
make each reduction over the batch global themselves (ops/losses.py,
models/layers.py, train/steps.py), so that W ranks compute what one process
computes on all B images.

The collectives are `all_reduce` and `broadcast` only, the two that gloo
also carries on CUDA tensors. With no group every function here is the
identity (or a no-op) and the port runs as a single process.

`launch` starts the ranks: one spawned process per device, joined through a
file store in a temporary directory (no TCP port), or, in a process that
`torchrun` started (WORLD_SIZE is set), torchrun's group.
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
import signal
import tempfile
import time
from typing import Any, Callable, Iterable, Sequence

import torch
import torch.distributed as dist

# The rendezvous and each collective: a rank silent for this long (hung, or
# waiting on a peer that is) fails the launch. The longest wait of a sound
# run is under a minute: the first step of a checkout whose kernels are not
# built yet, where every rank builds them at first use.
GROUP_TIMEOUT_S = 600.0


def auto_world_size(batch_size: int, num_devices: int, available: int) -> int:
    """Largest device count <= available that divides the global batch.

    `num_devices` 0 means every one of `available` devices. The same value as
    the JAX package's `auto_mesh_size(batch_size, num_devices)` with
    `available` devices (adaptsegnet_tpu/parallel/mesh.py:47-70), warning
    likewise when devices stay idle."""
    available = num_devices or available
    d = min(available, batch_size)
    while batch_size % d:
        d -= 1
    d = max(d, 1)
    if d < available:
        logging.getLogger(__name__).warning(
            "auto_world_size: batch %d uses only %d of %d devices "
            "(batch must be divisible by the world size; %d idle)",
            batch_size, d, available, available - d,
        )
    return d


def device_count(cpu: bool) -> int:
    """Devices a launch can use: the visible CUDA cards (at least 1, so that
    a run without a card reaches the port's "no CUDA device" error), or 1
    for the CPU."""
    return 1 if cpu else max(torch.cuda.device_count(), 1)


def started_by_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def active() -> bool:
    """Whether this process is in a group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group, as a new tensor without gradient;
    `t` itself with no group."""
    if not active():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; each rank's dx is the sum over ranks of dy,
    since every rank's loss depends on y."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """all_reduce_sum through which gradients flow (batch statistics that a
    loss differentiates); `t` itself with no group."""
    return _AllReduceSum.apply(t) if active() else t


def all_reduce_grads(modules: Iterable[torch.nn.Module | None]) -> None:
    """Sum the gradients of each module's trainable parameters over the
    group: one collective per module on a flat buffer, in the fixed order of
    `module.parameters()` (each parameter once, whatever an optimizer's
    groups list). A missing gradient counts as zeros and is set from the
    sum."""
    if not active():
        return
    for m in modules:
        if m is None:
            continue
        params = [p for p in m.parameters() if p.requires_grad]
        if not params:
            continue
        flat = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
            for p in params])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            g = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)


def _state_tensors(state) -> list[torch.Tensor]:
    """Parameters, buffers and optimizer-state tensors of a TrainState (or
    of a module), in a fixed order."""
    if isinstance(state, torch.nn.Module):
        modules, optimizers = [state], []
    else:
        modules = [state.model, state.d1, state.d2, state.warper]
        optimizers = [state.g_opt, state.d1_opt, state.d2_opt]
    tensors = []
    for m in modules:
        if m is not None:
            tensors += [*m.parameters(), *m.buffers()]
    for opt in optimizers:
        if opt is None:
            continue
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                tensors += [st[k] for k in sorted(st)
                            if isinstance(st[k], torch.Tensor)]
    return tensors


@torch.no_grad()
def broadcast_state(state) -> None:
    """Send the parameters, buffers and optimizer states (and the step
    count) of rank 0 to every rank, one collective per dtype: the
    counterpart of the JAX package's `replicate`. No-op with no group."""
    if not active():
        return
    tensors = _state_tensors(state)
    if not tensors:
        return
    device = tensors[0].device
    if hasattr(state, "step"):
        step = torch.tensor([state.step], dtype=torch.float64, device=device)
        dist.broadcast(step, src=0)
        state.step = int(step.item())
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(device) for t in ts])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def broadcast_bytes(data: bytes | None, device: torch.device) -> bytes | None:
    """Rank 0's `data` (None for nothing) on every rank, carried by a uint8
    tensor on `device`; `data` itself with no group."""
    if not active():
        return data
    size = torch.tensor([-1 if data is None else len(data)],
                        dtype=torch.int64, device=device)
    dist.broadcast(size, src=0)
    n = int(size.item())
    if n < 0:
        return None
    if rank() == 0:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device) \
            if n else torch.empty(0, dtype=torch.uint8, device=device)
    else:
        buf = torch.empty(n, dtype=torch.uint8, device=device)
    dist.broadcast(buf, src=0)
    return data if rank() == 0 else buf.cpu().numpy().tobytes()


def _join(rank_: int, world_size: int, cpu: bool, backend: str | None,
          device: int | None, init_method: str) -> None:
    if not cpu:
        torch.cuda.set_device(rank_ if device is None else device)
    dist.init_process_group(
        backend or ("gloo" if cpu else "nccl"), init_method=init_method,
        rank=rank_, world_size=world_size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def _worker(rank_, fn, args, world_size, cpu, backend, devices, store_dir):
    if cpu:  # ranks share the cores: oversubscribed threads spin and stall
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", 0)) or max(
            1, len(os.sched_getaffinity(0)) // world_size))
    _join(rank_, world_size, cpu, backend,
          None if devices is None else devices[rank_],
          "file://" + os.path.join(store_dir, "store"))
    # A rank that raises leaves its group to the process's exit, which
    # aborts it: destroy_process_group could wait on collectives that its
    # peers never join.
    torch.save(fn(*args), os.path.join(store_dir, f"rank{rank_}.pt"))
    dist.destroy_process_group()


def launch(fn: Callable[..., Any], world_size: int, cpu: bool = False,
           args: Sequence[Any] = (), backend: str | None = None,
           devices: Sequence[int] | None = None,
           timeout: float | None = None) -> list[Any]:
    """Run `fn(*args)` on `world_size` ranks; returns each rank's result.

    Each rank is a spawned process that calls `torch.cuda.set_device` (rank
    r on card `devices[r]`, by default card r) before anything touches the
    card, then joins the group: NCCL on the card, gloo with `cpu`, or
    `backend` if given (gloo on the card serves ranks that share one card,
    which NCCL refuses). `fn` and `args` must pickle; results go back
    through files (map tensors to the CPU). A rank that raises or dies fails
    the launch and ends the others; so does `timeout` (seconds, None for
    none). GROUP_TIMEOUT_S bounds the rendezvous and every collective, so a
    rank that hangs fails the launch once its peers have waited that long
    in their next collective.

    In a process started by torchrun, the group is torchrun's: this process
    joins it (its rank's card is LOCAL_RANK) and runs `fn` itself;
    `world_size` is then torchrun's and the result list holds this rank's
    result only.
    """
    import torch.multiprocessing as mp

    if started_by_torchrun():
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        _join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), cpu,
              backend, local if devices is None else devices[local],
              "env://")
        result = fn(*args)  # on failure, as in _worker
        dist.destroy_process_group()
        return [result]
    if devices is not None and len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    if not cpu and devices is None and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} ranks need {world_size} CUDA cards, "
                         f"{torch.cuda.device_count()} visible")
    store_dir = tempfile.mkdtemp(prefix="asn_group_")
    forwarded = {}
    try:
        ctx = mp.start_processes(
            _worker, args=(fn, tuple(args), world_size, cpu, backend,
                           None if devices is None else list(devices),
                           store_dir),
            nprocs=world_size, join=False, start_method="spawn")
        # SIGTERM / SIGINT go on to the ranks, whose train loop stops at a
        # step they agree on; this process waits for them.
        def forward(sig, frame):
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, sig)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                forwarded[sig] = signal.signal(sig, forward)
            except ValueError:  # not the main thread: nothing to forward
                pass
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):  # raises when a rank fails
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"launch: {world_size} ranks did not finish in {timeout} s")
        return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
    finally:
        for sig, handler in forwarded.items():
            signal.signal(sig, handler)
        shutil.rmtree(store_dir, ignore_errors=True)
