"""torch `.pth` state dicts <-> the port's modules, and flax trees -> the port.

The port's modules use the reference's torch state-dict keys
(`conv1.weight`, `layer3.5.conv2.weight`, `layer1.0.downsample.1.running_var`,
`layer5.conv2d_list.0.weight`, ...), so a released checkpoint or a snapshot
loads with `load_state_dict`. Two pieces of key surgery are kept from the
JAX package's interop (adaptsegnet_tpu/utils/pth_interop.py): the
DataParallel `module.` and caffe `Scale.` prefixes are stripped, and
`num_batches_tracked` buffers are dropped.

`from_jax_variables` carries a flax `{'params', 'batch_stats'}` tree of
numpy arrays across to the port's keys (HWIO -> OIHW, BN
`scale`/`mean`/`var` -> `weight`/`running_mean`/`running_var`), for
DeeplabMulti / DeeplabSingle / ResNetBackbone trees, DeeplabVGG trees
(`conv1_1`..`fc7` -> the reference's `features.<i>`, with or without the
JAX train adapter's `vgg` level), FCDiscriminator trees (`conv1`..`conv4`,
`classifier`) and Warper trees (`encoder_d`, `decoder_d`: transposed convs
HWIO -> (Cin, Cout, 4, 4), the `spectral` collection's `u` vectors) and
the trees of the zoo's blocks in models/custom_blocks.py (PReLU `alpha` ->
`weight`, OneOneConvolution's `one_one_kernel` / `one_one_bias` ->
`one_one.1.*`, Connection's `one_one_<i>` -> `container.<i>`, each conv's
inner `conv` level dropped): the parity tests load identical weights into
both packages with it.

The Warper's keys are the reference's; `warper_state_dict` is the
counterpart of the JAX package's `warper_state_dict_to_variables`
(adaptsegnet_tpu/utils/pth_interop.py:218): a reference Warper `.pth` minus
the never-called `connection.*` module.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_BLOCK_RE = re.compile(r"^layer([1-4])_block(\d+)$")
_BN_LEAVES = {
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def strip_prefix(key: str) -> str:
    """Strip 'module.' (DataParallel) and 'Scale.' (caffe-converted init)
    prefixes."""
    for p in ("module.", "Scale."):
        if key.startswith(p):
            key = key[len(p):]
    return key


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a `.pth` file into CPU tensors under the port's keys."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    return {
        strip_prefix(k): torch.as_tensor(v)
        for k, v in raw.items()
        if not k.endswith("num_batches_tracked")
    }


def save_torch_state_dict(sd: Mapping[str, torch.Tensor], path: str) -> None:
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)


def load_into(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> list[str]:
    """Load `sd` over `model`'s freshly initialised weights.

    Keys absent from `sd` keep their initial values (the reference's
    filtered load, evaluate_cityscapes.py:137-141); a key the model does
    not have, or a shape that differs, raises. Returns the missing keys.
    """
    result = model.load_state_dict(dict(sd), strict=False)
    if result.unexpected_keys:
        raise KeyError(
            f"checkpoint keys not present in the model: "
            f"{sorted(result.unexpected_keys)[:8]}"
        )
    return list(result.missing_keys)


_DISC_CONVS = {"conv1", "conv2", "conv3", "conv4", "classifier"}
# The JAX DeeplabVGG's conv names -> their index in the reference's pruned
# `features` Sequential (adaptsegnet_tpu/utils/pth_interop.py:73).
VGG_NAME_TO_IDX = {
    "conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
    "conv4_1": 17, "conv4_2": 19, "conv4_3": 21,
    "conv5_1": 23, "conv5_2": 25, "conv5_3": 27,
    "fc6": 29, "fc7": 31,
}


def _torch_key(path: tuple[str, ...]) -> str:
    """Flax path (without collection) -> the port's state-dict key."""
    if path[0] in ("backbone", "vgg"):
        path = path[1:]
    head = path[0]
    if head in VGG_NAME_TO_IDX:
        leaf = "weight" if path[-1] == "kernel" else "bias"
        return f"features.{VGG_NAME_TO_IDX[head]}.{leaf}"
    if head in _DISC_CONVS and path[1] == "conv" and len(path) == 3:
        return f"{head}.{'weight' if path[2] == 'kernel' else 'bias'}"
    if head in ("layer5", "layer6", "classifier"):
        _, branch, _, leaf = path
        idx = int(branch.removeprefix("branch"))
        return f"{head}.conv2d_list.{idx}.{'weight' if leaf == 'kernel' else 'bias'}"
    if head in ("conv1", "bn1"):
        prefix, (mod, leaf) = head, path[1:]
    else:
        m = _BLOCK_RE.match(head)
        if m is None:
            raise KeyError(f"unrecognized flax path: {'/'.join(path)}")
        name = {"downsample_conv": "downsample.0",
                "downsample_bn": "downsample.1"}.get(path[1], path[1])
        prefix = f"layer{m.group(1)}.{int(m.group(2))}.{name}"
        mod, leaf = path[2:]
    if mod == "conv":
        return f"{prefix}.weight"
    return f"{prefix}.{_BN_LEAVES[leaf]}"


def _leaves(tree: Mapping[str, Any], path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


_WARPER_LEAVES = {"kernel": "weight", "u": "u", **_BN_LEAVES}
_WARPER_NAME_RE = re.compile(r"^(down|up)(\d+)(_bn|_conv)?$")


def _warper_key(path: tuple[str, ...], n_up: int, transposed: bool) -> str:
    """Flax Warper path -> the reference key (models/warper.py)."""
    part, name, leaf = path[0], path[1], _WARPER_LEAVES[path[-1]]
    conv_idx = 1 if transposed else 2  # ConvTranspose, or Upsample + conv
    if (part, name) == ("encoder_d", "out"):
        return f"encoder_d.out.down.1.{leaf}"
    if (part, name) == ("decoder_d", "output_conv"):
        return f"decoder_d.up_list.{n_up}.output.{conv_idx}.{leaf}"
    m = _WARPER_NAME_RE.match(name)
    if m is None:
        raise KeyError(f"unrecognized flax Warper path: {'/'.join(path)}")
    kind, i, suffix = m.group(1), int(m.group(2)), m.group(3)
    mod = "norm" if suffix == "_bn" else "l"
    if kind == "down":
        if i == 0:
            return f"encoder_d.down_list.0.input.{leaf}"
        return f"encoder_d.down_list.{i}.block.1.{mod}.{leaf}"
    return f"decoder_d.up_list.{i}.block.{conv_idx}.{mod}.{leaf}"


def _warper_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    leaves = [(path, v) for coll in ("params", "batch_stats", "spectral")
              for path, v in _leaves(variables.get(coll, {}))]
    dec = variables["params"]["decoder_d"]
    n_up = sum(1 for k in dec if k.endswith("_conv") and k.startswith("up"))
    transposed = any(path[0] == "decoder_d" and path[-1] == "kernel"
                     and np.shape(v)[0] == 4 for path, v in leaves)
    sd = {}
    for path, value in leaves:
        arr = np.array(value, dtype=np.float32)
        if path[-1] == "kernel":
            # HWIO -> OIHW, or -> (Cin, Cout, 4, 4) for a transposed conv
            t = (2, 3, 0, 1) if path[0] == "decoder_d" and transposed else (3, 2, 0, 1)
            arr = np.transpose(arr, t)
        sd[_warper_key(path, n_up, transposed)] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return sd


_BLOCK_MARKERS = {"alpha", "one_one_kernel", "input_conv", "one_one_0"}
_BLOCK_LEAVES = {"kernel": "weight", "alpha": "weight", "u": "u", **_BN_LEAVES}


def _is_block_tree(params: Mapping[str, Any]) -> bool:
    """A tree of one of the zoo's blocks (models/custom_blocks.py)."""
    return bool(_BLOCK_MARKERS & set(params)) or set(params) in (
        {"conv"}, {"conv", "bn"})


def _block_key(path: tuple[str, ...]) -> str:
    """Flax path of a zoo block -> the port's key: `one_one_kernel` ->
    `one_one.1.weight`, `one_one_<i>` -> `container.<i>`, `<m>/conv/<leaf>`
    and `<m>/bn/<leaf>` -> `<m>.<leaf>`."""
    parts: list[str] = []
    for i, name in enumerate(path):
        leaf = i == len(path) - 1
        if leaf and name.startswith("one_one_"):
            parts += ["one_one", "1", _BLOCK_LEAVES[name.removeprefix("one_one_")]]
        elif leaf:
            parts.append(_BLOCK_LEAVES[name])
        elif re.fullmatch(r"one_one_\d+", name):
            parts += ["container", name.removeprefix("one_one_")]
        elif name in ("conv", "bn") and i == len(path) - 2 and parts:
            continue  # the flax wrapper's inner level
        else:
            parts.append(name)
    return ".".join(parts)


def _block_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    sd = {}
    for coll in ("params", "batch_stats", "spectral"):
        for path, value in _leaves(variables.get(coll, {})):
            arr = np.array(value, dtype=np.float32)
            if path[-1] in ("kernel", "one_one_kernel"):
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
            sd[_block_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def from_jax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax DeeplabMulti / DeeplabSingle / ResNetBackbone / DeeplabVGG /
    FCDiscriminator / Warper / zoo-block variables -> port state dict."""
    params = variables.get("params", {})
    if "encoder_d" in params:
        return _warper_from_jax(variables)
    if _is_block_tree(params):
        return _block_from_jax(variables)
    sd: dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if path[-1] == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
            sd[_torch_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def warper_state_dict(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A reference Warper state dict (e.g. from `load_torch_state_dict`)
    restricted to the keys the port's Warper has: the `connection.*` module,
    constructed by the reference but never called (model/warper.py:27-33),
    is dropped. Load the result with `load_into`."""
    return {strip_prefix(k): v for k, v in sd.items()
            if not strip_prefix(k).startswith("connection.")
            and not k.endswith("num_batches_tracked")}
