"""The reference models and steps against adaptsegnet_tpu_torch's plain
CPU path at a tiny size, in float32 and on the same weights: a fault in
the reference shows here before the card. (A test may import both; the
reference may not.)"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark.lib import compare, harness, inputs, program  # noqa: E402
from benchmark.reference import models  # noqa: E402
from benchmark.reference.numerics import Numerics, round_fp8  # noqa: E402

CPU = torch.device("cpu")


def tiny(config: str, dtype: str = "float32") -> dict:
    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs", config + ".json")))
    cfg.update(blocks=[1, 1, 2, 1], input_size=[64, 64],
               eval_output_size=[128, 128], compute_dtype=dtype)
    if cfg.get("warper"):
        cfg["warper_num_layers"] = 6
    return cfg


def traffic(pool: int) -> dict:
    t = json.load(open(os.path.join(REPO, "benchmark", "traffic", "train-b16.json")))
    t.update(batch_per_card=2, pool=pool, cards=1)
    return t


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_segmenter_and_discriminator_forward():
    cfg = tiny("deeplabv2-r101-multilevel")
    w = inputs.make_weights(cfg, 17, CPU)
    state, _ = program.build_train(cfg, 17, w, CPU, 2)
    ref_g = models.DeeplabMulti(cfg, Numerics(), CPU)
    ref_g.load_state_dict(w["G"])
    ref_d = models.FCDiscriminator(cfg, Numerics(), CPU)
    ref_d.load_state_dict(w["D1"])
    batch = inputs.make_pool(cfg, traffic(1), 17, CPU)[0]
    with torch.no_grad():
        p1, p2 = state.model(batch["images"])
        r1, r2 = ref_g(batch["images"])
        assert rel(p1.permute(0, 3, 1, 2), r1) < 1e-5
        assert rel(p2.permute(0, 3, 1, 2), r2) < 1e-5
        sm = torch.softmax(models.upsample(r2, (64, 64)), 1)
        assert rel(state.d1(sm).permute(0, 3, 1, 2), ref_d(sm)) < 1e-5


def test_warper_flow_and_statistics():
    cfg = tiny("deeplabv2-r101-warper-srconly")
    w = inputs.make_weights(cfg, 18, CPU)
    state, _ = program.build_train(cfg, 18, w, CPU, 2)
    ref = models.Warper(cfg, Numerics(), CPU)
    ref.load_state_dict(w["W"])
    images = inputs.make_pool(cfg, traffic(1), 18, CPU)[0]["images"]
    state.warper.train()
    with torch.no_grad():
        flow, _ = state.warper(images)
        assert rel(flow, ref(images)) < 1e-5
    for (n, a), (m, b) in zip(state.warper.named_buffers(), ref.named_buffers()):
        assert n == m and rel(a, b) < 1e-5


@pytest.mark.parametrize("config", ["deeplabv2-r101-multilevel",
                                    "deeplabv2-r101-warper-srconly"])
def test_three_steps_agree(config):
    """The program in float32 and the reference on the same weights and
    batches: losses, first gradients and changes within round-off."""
    cfg = tiny(config)
    spec = {"cfg": cfg, "traffic": traffic(3)}
    _, _, _, prog = harness.train_setup(spec, 19, CPU)
    ref = harness.reference_train(cfg, spec["traffic"], 19, CPU)
    nums = compare.train_numbers(prog, ref)
    assert max(nums.values()) < 1e-4, nums


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.0])
    y = round_fp8(x)
    assert y[0] == 1.0 and y[2] == 1.125 and y[3] == 448.0 and y[4] == -3.0
    assert y[1] in (1.0, 1.125)
