"""Layer shapes of the DeepLab-v2 segmenter, its discriminator and the
Warper at a configuration's sizes, for the work tables: each convolution
as a dict of its input and output sizes, from the configuration alone.

A convolution: {'name', 'cin', 'cout', 'k', 'stride', 'dil', 'h', 'w'
(input), 'ho', 'wo' (output), 'bias'}. Its multiply-adds per image are
ho * wo * cout * cin * k * k, its operations twice that, as for any
convolution whatever its padding.
"""

from __future__ import annotations


def _conv(name, cin, cout, k, stride, dil, h, w, pad, bias=False) -> dict:
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    return dict(name=name, cin=cin, cout=cout, k=k, stride=stride, dil=dil,
                h=h, w=w, ho=ho, wo=wo, bias=bias)


def conv_ops(conv: dict, n: int = 1) -> int:
    """Operations (2 per multiply-add) of the convolution's forward on n
    images; its dgrad and its wgrad take as many each."""
    return (2 * n * conv["ho"] * conv["wo"] * conv["cout"] * conv["cin"]
            * conv["k"] ** 2)


def backbone(cfg: dict, hw) -> list[dict]:
    """conv1 to layer4 in order, projection shortcuts after their block's
    third convolution."""
    h, w = hw
    convs = [_conv("conv1", 3, 64, 7, 2, 1, h, w, 3)]
    h, w = convs[0]["ho"], convs[0]["wo"]
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1  # 3x3/2 max pool
    cin = 64
    for li, (blocks, planes, stride, dil) in enumerate(zip(
            cfg["blocks"], cfg["planes"], cfg["strides"], cfg["dilations"]),
            start=1):
        for b in range(blocks):
            s = stride if b == 0 else 1
            pre = f"layer{li}.{b}"
            c1 = _conv(pre + ".conv1", cin, planes, 1, s, 1, h, w, 0)
            h2, w2 = c1["ho"], c1["wo"]
            convs += [c1,
                      _conv(pre + ".conv2", planes, planes, 3, 1, dil, h2, w2,
                            dil),
                      _conv(pre + ".conv3", planes, planes * 4, 1, 1, 1, h2,
                            w2, 0)]
            if b == 0:
                convs.append(_conv(pre + ".downsample.0", cin, planes * 4, 1,
                                   s, 1, h, w, 0))
            h, w, cin = h2, w2, planes * 4
    return convs


def feature_hw(cfg: dict, hw, layer: int) -> tuple[int, int, int]:
    """(h, w, channels) of layer `layer`'s output."""
    last = [c for c in backbone(cfg, hw)
            if c["name"].startswith(f"layer{layer}.")][-1]
    return last["ho"], last["wo"], last["cout"]


def aspp(cfg: dict, hw, layer: int, head: str) -> list[dict]:
    """The four dilated 3x3 branches of the ASPP head on layer `layer`."""
    h, w, c = feature_hw(cfg, hw, layer)
    return [_conv(f"{head}.conv2d_list.{i}", c, cfg["num_classes"], 3, 1, d,
                  h, w, d, bias=True)
            for i, d in enumerate(cfg["aspp_dilations"])]


def discriminator(cfg: dict, hw) -> list[dict]:
    h, w = hw
    widths = [cfg["num_classes"], *cfg["d_widths"], 1]
    names = ("conv1", "conv2", "conv3", "conv4", "classifier")
    convs = []
    for name, cin, cout in zip(names, widths[:-1], widths[1:]):
        convs.append(_conv(name, cin, cout, 4, 2, 1, h, w, 1, bias=True))
        h, w = convs[-1]["ho"], convs[-1]["wo"]
    return convs


def warper(cfg: dict, hw) -> list[dict]:
    """The Warper's encoder (4x4/2) and decoder (3x3 after a x2 upsample)
    convolutions; decoder inputs hold the concatenated skip."""
    layers = cfg["warper_num_layers"]
    widths = [64, 128, 256, 512] + [512] * (layers - 5)
    h, w = hw
    convs, cin = [], 3
    for i, cout in enumerate(widths):
        convs.append(_conv(f"encoder.down{i}", cin, cout, 4, 2, 1, h, w, 1))
        h, w, cin = convs[-1]["ho"], convs[-1]["wo"], cout
    convs.append(_conv("encoder.out", cin, 512, 4, 2, 1, h, w, 1))
    h, w, cin = convs[-1]["ho"], convs[-1]["wo"], 512
    for i, cout in enumerate([512] * (layers - 4) + [256, 128, 64]):
        width = cin if i == 0 else 2 * cin
        convs.append(_conv(f"decoder.up{i}", width, cout, 3, 1, 1, 2 * h,
                           2 * w, 1))
        h, w, cin = 2 * h, 2 * w, cout
    convs.append(_conv("decoder.output", cin, 2, 3, 1, 1, 2 * h, 2 * w, 1,
                       bias=True))
    return convs
