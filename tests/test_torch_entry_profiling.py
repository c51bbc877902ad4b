"""The port's entry point and its step profiler against the JAX package's.

`entry()`: the example input is the JAX entry's (1, 256, 512, 3) and the
outputs its (1, 32, 64, 19) pair; its forward on the weights of a flax
DeeplabMulti cut to one bottleneck per stage (carried across by
`from_jax_variables`, BN statistics randomised) matches flax at rtol 1e-4
/ atol 1e-4 (f32 sums in other orders through the cut net).
`dryrun_multichip(2, cpu=True)` runs in a fresh subprocess, with a time
limit, as tests/test_graft_entry.py:17 runs the JAX one. The profiler:
`trace` + `op_stats` round-trip on a tiny CPU workload (JAX's row keys,
sorted by self time; `print_op_stats` runs), a missing trace raises, and
`cli.profile_step` has the JAX CLI's flags and defaults.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from adaptsegnet_tpu.cli import profile_step as jax_profile_step
from adaptsegnet_tpu.models.deeplab_resnet import (
    ClassifierModule as JaxClassifierModule,
    ResNetBackbone as JaxResNetBackbone,
)
from adaptsegnet_tpu_torch import entry
from adaptsegnet_tpu_torch.cli import profile_step
from adaptsegnet_tpu_torch.utils import pth_interop
from adaptsegnet_tpu_torch.utils.profiling import (
    StepTimer,
    op_stats,
    op_type,
    print_op_stats,
    trace,
)
from tests.test_torch_models import randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = (1, 1, 1, 1)


class JaxCutMulti(nn.Module):
    """flax DeeplabMulti's structure with `CUT` bottlenecks per stage."""

    @nn.compact
    def __call__(self, x):
        feats = JaxResNetBackbone(layers=CUT, name="backbone")(x)
        return (JaxClassifierModule(19, name="layer5")(feats["layer3"]),
                JaxClassifierModule(19, name="layer6")(feats["layer4"]))


def test_entry_matches_jax_forward(rng):
    fn, (model, x) = entry.entry(device="cpu")
    assert tuple(x.shape) == entry.EXAMPLE_SHAPE == (1, 256, 512, 3)
    for li, blocks in enumerate(CUT, start=1):
        stage = getattr(model, f"layer{li}")
        setattr(model, f"layer{li}", stage[:blocks])
    images = rng.standard_normal(entry.EXAMPLE_SHAPE).astype(np.float32)
    jm = JaxCutMulti()
    variables = randomize_bn(jax.device_get(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))), rng)
    assert pth_interop.load_into(model, pth_interop.from_jax_variables(variables)) == []
    ref = jax.jit(jm.apply)(variables, jnp.asarray(images))
    ours = fn(model, torch.from_numpy(images))
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == (1, 32, 64, 19)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_dryrun_multichip_fresh_subprocess():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    # one thread per rank: the suite's workers already share the cores
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", "from adaptsegnet_tpu_torch import entry; "
         "entry.dryrun_multichip(2, cpu=True)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip ok" in proc.stdout
    assert "dryrun_multichip warper ok" in proc.stdout


def test_dryrun_multichip_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        entry.dryrun_multichip(2)


def _workload():
    w = torch.randn(8, 4, 3, 3)
    x = torch.randn(2, 4, 16, 16)
    for _ in range(3):
        y = F.relu(F.conv2d(x, w, padding=1))
        (y @ y.transpose(-1, -2)).sum()


def test_trace_op_stats_round_trip(tmp_path, capsys):
    with trace(str(tmp_path)):
        _workload()
    rows = op_stats(str(tmp_path), device_only=False)
    assert rows and set(rows[0]) == {"host_or_device", "op_type", "op_name",
                                     "occurrences", "self_us"}
    selfs = [r["self_us"] for r in rows]
    assert selfs == sorted(selfs, reverse=True) and min(selfs) >= 0
    names = {r["op_name"]: r for r in rows}
    assert names["aten::conv2d"]["occurrences"] == 3
    assert all(r["host_or_device"] == "Host" for r in rows)
    assert op_stats(str(tmp_path)) == []  # no card: no device rows
    print_op_stats(rows, top=5, iters=3)
    out = capsys.readouterr().out
    assert "rollup by op type" in out and "aten::conv2d" in out


def test_op_stats_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        op_stats(str(tmp_path))


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::sm90::(anonymous namespace)::"
     "conv_sm90_kernel<2, 256>(CUtensorMap_st, Geo)", "conv_sm90_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>(int, float)", "vectorized_elementwise_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "sm90_xmma_fprop_implicit_gemm_bf16"),
    ("aten::conv2d", "aten::conv2d"),
])
def test_op_type_names_the_kernel(name, short):
    assert op_type(name) == short


def test_step_timer_discards_warmup():
    t = StepTimer(warmup=1)
    for _ in range(3):
        t.start()
        t.stop()
    assert len(t._times) == 2 and t.best <= t.p50 <= max(t._times)


def test_profile_step_flags_match_jax():
    for argv in ([], ["--top", "5", "--iters", "3", "--source-only",
                      "--warper", "--dtype", "float32", "--batch", "2",
                      "--trace-dir", "/x"]):
        assert (vars(profile_step.get_arguments(argv))
                == vars(jax_profile_step.get_arguments(argv)))
    with pytest.raises(SystemExit):
        profile_step.get_arguments(["--cpu"])
