"""Data-parallel train steps: a group of 2 gloo ranks on the CPU against the
JAX step on the same global batch, and against the port in one process.

Under a mesh the JAX step computes the same function as on one device with
the whole global batch (tests/test_parallel.py:18), so the JAX side runs on
one device with the global batch of 2. The port's 2 ranks (launched by
`parallel.launch`, cpu=True, each with its own time limit) each take their
interleaved half of it. Cases: multi-level, single-level and source-only
with a 5-layer Warper, the multi-level step with `bn_mode='batch'` on the
twin conv + BN segmenter, iter_size 2, a global batch whose two images have
different ignore counts (one 90 % ignored: the cross-entropy's mean is over
the global count of valid pixels), and the duplicated-parameter SGD
(--optim-dup-quirk's KFoldSGD, k = 1, 3, 4). Twin modules and weights from
tests/test_torch_train_steps.py, test_torch_warper_steps.py and
test_torch_train_flags.py. One step each; the metrics and every parameter,
buffer and Warper running statistic after it agree at rtol 1e-4 / atol 1e-5
(tests/test_parallel.py:45-51) with the JAX step and with the 1-process
port, and the two ranks hold bit-identical states.
"""

import copy
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adaptsegnet_tpu.train.optim import generator_param_labels, make_generator_tx
from adaptsegnet_tpu.train.state import GeneratorState, TrainState as JaxTrainState
from adaptsegnet_tpu.train.steps import (
    make_adversarial_step as jax_adversarial_step,
    make_source_only_step as jax_source_only_step,
)
from adaptsegnet_tpu_torch.parallel import group
from adaptsegnet_tpu_torch.train.optim import KFoldSGD, make_generator_optimizer
from adaptsegnet_tpu_torch.train.state import Schedule, TrainState
from adaptsegnet_tpu_torch.train.steps import (
    make_adversarial_step,
    make_source_only_step,
)
from adaptsegnet_tpu_torch.utils import pth_interop
from tests import test_torch_train_flags as flags
from tests import test_torch_train_steps as tsteps
from tests import test_torch_warper_steps as wsteps
from tests.test_torch_models import randomize_bn

RTOL, ATOL = 1e-4, 1e-5
LAUNCH_TIMEOUT_S = 300
CASES = ("multi-level", "single-level-warper", "source-only-warper",
         "bn-batch", "iter-size-2", "uneven-ignore", "dup-quirk")


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_rank():
    """The ranks take one CPU thread each: the suite's workers already
    share the cores, and oversubscribed threads spin."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _seg_sd(jstate, _state) -> dict:
    """The twin TinySeg's parameters of a JAX state, under the port's keys."""
    seg = jax.device_get(jstate.generator.params)
    sd = {}
    for name, *_ in tsteps._SEG:
        sd[f"{name}.weight"] = np.asarray(seg[name]["conv"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{name}.bias"] = np.asarray(seg[name]["conv"]["bias"])
    return sd


def _bn_seg_sd(jstate, _state) -> dict:
    tiny = flags.TinyBNSeg("batch")
    flags._load_tiny(tiny, flags._np_tree({
        "params": jstate.generator.params,
        "batch_stats": jstate.generator.batch_stats}))
    return {k: v.numpy() for k, v in tiny.state_dict().items()}


def _jax_sds(jstate, seg_sd) -> dict:
    """{module: {key: array}} of a JAX state, under the port's keys."""
    out = {"model": seg_sd(jstate, None)}
    for i in (1, 2):
        jd = getattr(jstate, f"d{i}")
        if jd is not None:
            out[f"d{i}"] = {k: v.numpy() for k, v in pth_interop.from_jax_variables(
                {"params": jax.device_get(jd.params)}).items()}
    if jstate.warper is not None:
        out["warper"] = {k: v.numpy() for k, v in pth_interop.from_jax_variables(
            jax.device_get({"params": jstate.warper.params,
                            **jstate.warper.stats})).items()}
    return out


def _port_sds(state) -> dict:
    return {name: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
            for name, m in (("model", state.model), ("d1", state.d1),
                            ("d2", state.d2), ("warper", state.warper))
            if m is not None}


def _dup_quirk(jstate, state):
    """KFoldSGD with k = 1 (stem), 3 (mid), 4 (down) and the 10x heads at
    1, against the optax chain with the same multiplicities."""
    jparams = jstate.generator.params
    ks = {"stem": 1, "mid": 3, "down": 4, "layer5": 1, "layer6": 1}
    mults = {name: jax.tree.map(lambda _: ks[name], node)
             for name, node in jparams.items()}
    jstate = jstate.replace(generator=GeneratorState.create(
        jparams, {}, make_generator_tx(
            generator_param_labels(jparams), base_lr=tsteps.LR,
            num_steps=tsteps.STEPS, dup_mults=mults)))
    model = state.model
    groups = [{"params": [getattr(model, n).weight, getattr(model, n).bias],
               "lr_mult": 10.0 if n.startswith("layer") else 1.0, "k": k}
              for n, k in ks.items()]
    state.g_opt = KFoldSGD(groups, lr=tsteps.LR, momentum=0.9,
                           weight_decay=5e-4)
    return jstate, state


def _bn_batch_case(rng):
    jseg = flags.JaxTinyBNSeg(bn_mode="batch")
    variables = randomize_bn(jax.device_get(jseg.init(
        jax.random.PRNGKey(5), jnp.zeros((1,) + flags.HW + (3,)))), rng)
    for node in variables["params"].values():
        if "conv" in node:
            node["conv"]["kernel"] = (rng.standard_normal(
                node["conv"]["kernel"].shape) * 0.3).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        generator=GeneratorState.create(
            jparams, jax.tree.map(jnp.asarray, variables["batch_stats"]),
            make_generator_tx(generator_param_labels(jparams),
                              base_lr=flags.LR, num_steps=flags.STEPS)))
    tiny = flags.TinyBNSeg("batch")
    flags._load_tiny(tiny, variables)
    state = TrainState(model=tiny, g_opt=make_generator_optimizer(tiny, flags.LR),
                       schedule=Schedule(flags.LR, flags.LR_D, flags.STEPS))
    disc, jstate = flags._discriminators(state, jstate, (1, 2))
    return jseg, disc, jstate, state


def build_case(name, rng):
    """(JAX state, JAX step, port state, port step spec, global batch,
    seg_sd)."""
    seg_sd, iter_size = _seg_sd, 1
    if name == "bn-batch":
        jseg, disc, jstate, state = _bn_batch_case(rng)
        seg_sd = _bn_seg_sd
        jstep = jax_adversarial_step(jseg, disc, level="multi-level",
                                     input_hw=flags.HW, donate=False)
        spec = ("adv", dict(level="multi-level", input_hw=flags.HW))
        batch = flags._batch(rng, 2)
    elif name.endswith("-warper"):
        single = name.startswith("single")
        disc, jstate, state = tsteps.twin_states(rng, multi=False,
                                                 with_d=single)
        jw, jstate, _ = wsteps.add_warper(jstate, state)
        batch = wsteps.make_batch(rng, 1)
        if single:
            jstep = jax_adversarial_step(
                tsteps.JaxTinySeg(), disc, level="single-level",
                input_hw=wsteps.HW, warper_module=jw, donate=False)
            spec = ("adv", dict(level="single-level", input_hw=wsteps.HW))
        else:
            jstep = jax_source_only_step(tsteps.JaxTinySeg(), warper_module=jw,
                                         input_hw=wsteps.HW, donate=False)
            spec = ("src", dict(input_hw=wsteps.HW))
            del batch["target_images"]
    else:
        iter_size = 2 if name == "iter-size-2" else 1
        disc, jstate, state = tsteps.twin_states(rng, multi=True)
        if name == "dup-quirk":
            jstate, state = _dup_quirk(jstate, state)
        jstep = jax_adversarial_step(tsteps.JaxTinySeg(), disc,
                                     level="multi-level", input_hw=tsteps.HW,
                                     iter_size=iter_size, donate=False)
        spec = ("adv", dict(level="multi-level", input_hw=tsteps.HW,
                            iter_size=iter_size))
        batch = tsteps.make_batch(rng, iter_size)
        if name == "uneven-ignore":  # image 0 90 % ignored, image 1 none
            labels = batch["labels"][0]
            labels[1] = rng.integers(0, tsteps.C, labels.shape[1:])
            labels[0][rng.random(labels.shape[1:]) < 0.9] = 255
    return jstate, jstep, state, spec, batch, seg_sd


def _make_step(spec):
    kind, kwargs = spec
    return (make_adversarial_step(**kwargs) if kind == "adv"
            else make_source_only_step(**kwargs))


def rank_steps(payload: bytes) -> dict:
    """One step of every case on this rank's interleaved half of its batch;
    returns {case: (metrics, state dicts)}."""
    cases = torch.load(io.BytesIO(payload), weights_only=False)
    r, w = group.rank(), group.world()
    out = {}
    for name, (state, spec, batch) in cases.items():
        local = {k: torch.from_numpy(np.ascontiguousarray(v[:, r::w]))
                 for k, v in batch.items()}
        metrics = _make_step(spec)(state, local)
        out[name] = ({k: float(v) for k, v in metrics.items()}, _port_sds(state))
    return out


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(2024)
    built = {name: build_case(name, rng) for name in CASES}
    buf = io.BytesIO()
    torch.save({name: (copy.deepcopy(c[2]), c[3], c[4])
                for name, c in built.items()}, buf)
    ranks = group.launch(rank_steps, 2, cpu=True, args=(buf.getvalue(),),
                         timeout=LAUNCH_TIMEOUT_S)
    out = {}
    for name, (jstate, jstep, state, spec, batch, seg_sd) in built.items():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics = _make_step(spec)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        out[name] = {
            "jax": ({k: float(v) for k, v in jm.items()},
                    _jax_sds(jstate, seg_sd)),
            "one": ({k: float(v) for k, v in metrics.items()}, _port_sds(state)),
            "ranks": [r[name] for r in ranks],
        }
    return out


def _assert_close(got, ref, what):
    g_metrics, g_sds = got
    r_metrics, r_sds = ref
    assert set(g_metrics) == set(r_metrics), what
    for k in r_metrics:
        np.testing.assert_allclose(g_metrics[k], r_metrics[k], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: {k}")
    assert set(g_sds) == set(r_sds), what
    for mod, sd in r_sds.items():
        assert set(g_sds[mod]) == set(sd), (what, mod)
        for k, v in sd.items():
            np.testing.assert_allclose(
                np.asarray(g_sds[mod][k], np.float32), np.asarray(v, np.float32),
                rtol=RTOL, atol=ATOL, err_msg=f"{what}: {mod}.{k}")


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_jax(runs, case):
    _assert_close(runs[case]["ranks"][0], runs[case]["jax"], f"{case} vs JAX")


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_one_process(runs, case):
    _assert_close(runs[case]["ranks"][0], runs[case]["one"],
                  f"{case} vs 1 process")


def test_ranks_hold_identical_states(runs):
    """The metrics and the gradients are all-reduced, so both ranks take
    the same update bit for bit; the Warper's and the batch-mode BN's
    running statistics are the global batch's on both."""
    for case, run in runs.items():
        (m0, sd0), (m1, sd1) = run["ranks"]
        assert m0 == m1, case
        for mod, sd in sd0.items():
            for k, v in sd.items():
                assert torch.equal(v, sd1[mod][k]), (case, mod, k)

