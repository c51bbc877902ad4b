"""The benchmark's inputs, made on the card from the run's seed: the
weights of every module in the reference's state-dict keys, and batches
of preprocessed noise images with their labels. The same seed gives the
same tensors, whatever the card: each module and the data draw from
`torch.Generator`s on the device, seeded from (seed, stream), in a few
large calls.

Weights follow the laws the reference initialises with, with
checkpoint-like BatchNorm statistics in the segmenter, so that the frozen
BatchNorm folds do real work (as `chip_smoke.py` makes them):
* segmenter convolutions N(0, 0.01), ASPP biases 0; BatchNorm scale
  U[0.5, 1.5), shift 0.1 N(0, 1), mean N(0, 1), variance U[0.5, 2);
* discriminator convolutions and biases U(-b, b), b = 1 / sqrt(fan in),
  torch's Conv2d default;
* Warper convolutions xavier-normal with gain 0.02, output bias 0,
  BatchNorm scale 1 + 0.02 N(0, 1), shift 0, fresh statistics (0, 1).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import models
from benchmark.reference.numerics import Numerics

# BGR means of the Caffe models that the reference subtracts.
IMG_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)
STREAMS = {"G": 0, "D1": 1, "D2": 2, "W": 3, "data": 4}


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + STREAMS[stream]) % (1 << 63))
    return g


def _shapes(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def module_shapes(cfg: dict) -> dict:
    """{module: {key: shape}} of the modules the configuration trains or
    uses, from the reference built on the meta device."""
    num, meta = Numerics(), torch.device("meta")
    out = {"G": _shapes(models.DeeplabMulti(cfg, num, meta))}
    if cfg["mode"] == "multi-level":
        d = _shapes(models.FCDiscriminator(cfg, num, meta))
        out["D1"], out["D2"] = d, dict(d)
    if cfg.get("warper"):
        out["W"] = _shapes(models.Warper(cfg, num, meta))
    return out


def _law(module: str, key: str, shape) -> tuple[str, float]:
    """(draw, scale): 'normal' N(0, scale), 'uniform' U(-scale, scale),
    'bn_scale' U[0.5, 1.5), 'bn_shift', 'bn_mean', 'bn_var', 'zeros',
    'ones', 'one_plus' 1 + scale N(0, 1)."""
    leaf = key.rsplit(".", 1)[1]
    if module == "G":
        if len(shape) == 4:
            return "normal", 0.01
        if key.split(".")[0] in ("layer5", "layer6"):
            return "zeros", 0.0
        return {"weight": ("bn_scale", 0.0), "bias": ("bn_shift", 0.0),
                "running_mean": ("bn_mean", 0.0),
                "running_var": ("bn_var", 0.0)}[leaf]
    if module in ("D1", "D2"):
        return "uniform", None  # bound from the conv's weight, below
    if len(shape) == 4:
        cout, cin, kh, kw = shape
        return "normal", 0.02 * math.sqrt(2.0 / (kh * kw * (cin + cout)))
    return {"weight": ("one_plus", 0.02), "bias": ("zeros", 0.0),
            "running_mean": ("zeros", 0.0), "running_var": ("ones", 0.0)}[leaf]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{module: state dict} of float32 tensors on `device`."""
    out = {}
    for module, shapes in module_shapes(cfg).items():
        laws = {k: _law(module, k, s) for k, s in shapes.items()}
        if module in ("D1", "D2"):
            for k in shapes:
                conv = k.rsplit(".", 1)[0]
                fan_in = math.prod(shapes[conv + ".weight"][1:])
                laws[k] = ("uniform", 1.0 / math.sqrt(fan_in))
        normal = [k for k, (d, _) in laws.items()
                  if d in ("normal", "bn_shift", "bn_mean", "one_plus")]
        uniform = [k for k, (d, _) in laws.items()
                   if d in ("uniform", "bn_scale", "bn_var")]
        gen = generator(seed, module, device)
        sizes_n = [math.prod(shapes[k]) for k in normal]
        sizes_u = [math.prod(shapes[k]) for k in uniform]
        flat_n = torch.randn(sum(sizes_n), generator=gen, device=device)
        flat_u = torch.rand(sum(sizes_u), generator=gen, device=device)
        sd = {}
        for keys, sizes, flat in ((normal, sizes_n, flat_n),
                                  (uniform, sizes_u, flat_u)):
            for k, part in zip(keys, torch.split(flat, sizes)):
                draw, scale = laws[k]
                part = part.view(shapes[k])
                sd[k] = {"normal": lambda t, s: t * s,
                         "bn_shift": lambda t, s: t * 0.1,
                         "bn_mean": lambda t, s: t,
                         "one_plus": lambda t, s: 1.0 + s * t,
                         "uniform": lambda t, s: (2.0 * t - 1.0) * s,
                         "bn_scale": lambda t, s: t + 0.5,
                         "bn_var": lambda t, s: t * 1.5 + 0.5}[draw](part, scale)
        for k, (draw, _) in laws.items():
            if draw in ("zeros", "ones"):
                sd[k] = (torch.zeros if draw == "zeros" else torch.ones)(
                    shapes[k], device=device)
        out[module] = {k: sd[k].contiguous() for k in shapes}
    return out


def make_labels(gen: torch.Generator, n: int, label_hw, classes: int,
                ignore: int, traffic: dict, device) -> torch.Tensor:
    """Label maps of regions, as segmentation labels are: each image draws
    its own mix of classes (uniform on the simplex: normalised exponential
    draws), each square block of `label_block` pixels one class from that
    mix, and a share `ignored_share` of the blocks is `ignore`. uint8 at
    `label_hw`. So images differ in their classes as scenes do, and a
    step's gradient depends on which images it saw."""
    block = traffic["label_block"]
    bh, bw = -(-label_hw[0] // block), -(-label_hw[1] // block)
    mix = -torch.log(torch.rand((n, classes), generator=gen, device=device))
    cls = torch.multinomial(mix / mix.sum(1, keepdim=True), bh * bw,
                            replacement=True, generator=gen)
    drop = torch.rand((n, bh * bw), generator=gen, device=device)
    cls = cls.masked_fill(drop < traffic["ignored_share"], ignore)
    cls = cls.view(n, bh, bw).to(torch.uint8)
    cls = cls.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return cls[:, :label_hw[0], :label_hw[1]].contiguous()


def make_batch(gen: torch.Generator, n: int, cfg: dict, traffic: dict,
               label_hw, target: bool, device) -> dict:
    """n noise images (uniform RGB in 0..255, as BGR minus the Caffe mean,
    NHWC float32 at the configuration's input size) and their labels
    (`make_labels`); `target` adds as many target-domain images."""
    hw = cfg["input_size"]

    def images():
        rgb = torch.randint(0, 256, (n, *hw, 3), generator=gen, device=device)
        mean = torch.tensor(IMG_MEAN_BGR, device=device)
        return (rgb.flip(-1).float() - mean).contiguous()

    batch = {"images": images(),
             "labels": make_labels(gen, n, label_hw, cfg["num_classes"],
                                   cfg["ignore_label"], traffic, device)}
    if target:
        batch["target_images"] = images()
    return batch


def make_pool(cfg: dict, traffic: dict, seed: int, device,
              part: slice | None = None) -> list[dict]:
    """The traffic's pool of distinct batches; `part` keeps that slice of
    each batch's images (one card's share of a global batch)."""
    gen = generator(seed, "data", device)
    n = traffic["batch_per_card"] * traffic.get("cards", 1)
    train = traffic["path"] == "train"
    label_hw = cfg["input_size"] if train else cfg["eval_output_size"]
    pool = []
    for _ in range(traffic["pool"]):
        batch = make_batch(gen, n, cfg, traffic, label_hw,
                           train and cfg["mode"] == "multi-level", device)
        if part is not None:
            batch = {k: v[part].contiguous() for k, v in batch.items()}
        pool.append(batch)
    return pool
