"""The work tables against hand counts: one layer of each kind, its
operations and bytes, and the launches of each path."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.lib import deeplab, peaks, plans, registry  # noqa: E402

FAM = registry.families()


def conv(cin, cout, k, stride, dil, h, w, pad, bias=False):
    return deeplab._conv("c", cin, cout, k, stride, dil, h, w, pad, bias)


def test_layer3_dilated_3x3_forward():
    # layer3's 3x3 at 64x128, 256 -> 256, dilation 2, 8 images
    c = conv(256, 256, 3, 1, 2, 64, 128, 2)
    assert (c["ho"], c["wo"]) == (64, 128)
    ops, nbytes = FAM["igemm_core"].work(dict(wrapper="conv3x3_dil_fwd", n=8, conv=c))
    assert ops == 2 * 8 * 64 * 128 * 256 * 256 * 9
    assert nbytes == 2 * (8 * 64 * 128 * 256 * 2 + 256 * 256 * 9)


def test_discriminator_conv2_forward_with_bias_and_wgrad():
    c = conv(64, 128, 4, 2, 1, 256, 512, 1, bias=True)
    assert (c["ho"], c["wo"]) == (128, 256)
    ops, nbytes = FAM["igemm_core"].work(dict(wrapper="conv4x4_s2_fwd", n=1, conv=c))
    assert ops == 2 * 128 * 256 * 128 * 64 * 16
    assert nbytes == 2 * (256 * 512 * 64 + 128 * 256 * 128 + 128 * 64 * 16) + 4 * 128
    ops_w, bytes_w = FAM["conv4x4_wgrad"].work(dict(wrapper="conv4x4_s2_wgrad", n=1, conv=c))
    assert ops_w == ops
    assert bytes_w == 2 * (256 * 512 * 64 + 128 * 256 * 128) + 4 * 128 * 64 * 16


def test_discriminator_conv1_patch_directions():
    c = conv(19, 64, 4, 2, 1, 512, 1024, 1, bias=True)
    x, y, w = 512 * 1024 * 19, 256 * 512 * 64, 64 * 19 * 16
    ops = 2 * 256 * 512 * 64 * 19 * 16
    fam = FAM["conv4x4_patch"]
    assert fam.work(dict(wrapper="conv4x4_patch_fwd", n=1, conv=c)) == (
        ops, 2 * (x + y + w) + 4 * 64)
    assert fam.work(dict(wrapper="conv4x4_patch_dgrad", n=1, conv=c)) == (
        ops, 2 * (x + y + w))
    assert fam.work(dict(wrapper="conv4x4_patch_wgrad", n=1, conv=c)) == (
        ops, 2 * (x + y) + 4 * w)


def test_upsample_warp_and_argmax():
    warp = dict(wrapper="upsample_warp_fwd", n=2, h=64, w=128, c=19, oh=512,
                ow=1024, es=2)
    p = 512 * 1024
    assert FAM["upsample_warp"].work(warp) == (
        2 * 9 * 2 * p * 19, 2 * 2 * (64 * 128 * 19 + p * 19) + 8 * 2 * p)
    am = dict(wrapper="upsample_argmax", n=1, h=64, w=128, c=19, oh=1024,
              ow=2048, es=2)
    assert FAM["upsample_argmax"].work(am) == (
        1024 * 2048 * 19 * 4 + 1024 * 128 * 19 * 3,
        64 * 128 * 19 * 2 + 1024 * 2048 + 8 * (2 * 1024 + 2 * 2048))


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0, "bf16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, "f32") == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 1.0, "f32") == pytest.approx(1.0)


def test_forward_shapes_and_operations():
    cfg = registry.cell("multilevel.eval-b16")["cfg"]
    g = deeplab.backbone(cfg, (512, 1024))
    assert len(g) == 1 + 3 * (3 + 4 + 23 + 3) + 4
    assert deeplab.feature_hw(cfg, (512, 1024), 4) == (64, 128, 2048)
    assert deeplab.feature_hw(cfg, (512, 1024), 1) == (128, 256, 256)
    stem = g[0]
    assert deeplab.conv_ops(stem) == 2 * 256 * 512 * 64 * 3 * 49


@pytest.mark.parametrize("path,launches", [
    ("multilevel", {"conv3x3_dil_fwd": 52, "conv3x3_dil_dgrad": 52,
                    "conv4x4_s2_fwd": 18, "conv4x4_s2_dgrad": 18,
                    "conv4x4_s2_wgrad": 12, "conv4x4_patch_fwd": 6,
                    "conv4x4_patch_dgrad": 2, "conv4x4_patch_wgrad": 4}),
    ("warper", {"conv3x3_dil_fwd": 26, "conv3x3_dil_dgrad": 26,
                "conv4x4_s2_fwd": 7, "upsample_warp_fwd": 1,
                "upsample_warp_dx": 1}),
    ("eval", {"conv3x3_dil_batched_fwd": 30, "upsample_argmax": 1}),
])
def test_launches_per_call(path, launches):
    """The launches per step of chip_smoke.py's STEP_LAUNCHES (phases 9, 12)
    and per batched eval call (phase 4: 30 + kernel 1 once)."""
    cell = {"multilevel": "multilevel.train-b16", "warper": "warper.train-b32",
            "eval": "multilevel.eval-b16"}[path]
    assert registry.cell(cell)["plan"]["launches"] == launches


def test_model_operations_of_a_multilevel_step():
    cfg = registry.cell("multilevel.train-b16")["cfg"]
    hw = (512, 1024)
    g = (deeplab.backbone(cfg, hw) + deeplab.aspp(cfg, hw, 3, "layer5")
         + deeplab.aspp(cfg, hw, 4, "layer6"))
    d = deeplab.discriminator(cfg, hw)
    fwd_g = sum(deeplab.conv_ops(c, 16) for c in g)
    fwd_d = sum(deeplab.conv_ops(c, 8) for c in d)
    want = 3 * fwd_g - deeplab.conv_ops(g[0], 16) + 2 * (
        8 * fwd_d - 2 * deeplab.conv_ops(d[0], 8))
    assert plans.train_multilevel(cfg, 8)["model_ops"] == want
    four = plans.train_multilevel(cfg, 8, cards=4)
    assert four["model_ops"] == 4 * want
    assert four["launches"] == plans.train_multilevel(cfg, 8)["launches"]
