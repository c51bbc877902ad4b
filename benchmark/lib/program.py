"""The system under test, adaptsegnet_tpu_torch, as its entry points build
it: the train state from `train/build.py::build_train_state` and the step
from `train/steps.py`, the eval function from
`eval/evaluator.py::make_eval_hist_fn`. The benchmark loads its own
weights into the program's modules and reads back only what the program
exposes: the step's metrics, the optimizers' states, the modules'
parameters and buffers, the wrappers' launch counters.
"""

from __future__ import annotations

import torch

from adaptsegnet_tpu_torch.ops import kernels
from adaptsegnet_tpu_torch.train.build import build_train_state
from adaptsegnet_tpu_torch.train.config import TrainConfig
from adaptsegnet_tpu_torch.train.steps import (
    make_adversarial_step,
    make_source_only_step,
)

MODULES = {"G": "model", "D1": "d1", "D2": "d2", "W": "warper"}


def train_config(cfg: dict, seed: int, batch_size: int) -> TrainConfig:
    h, w = cfg["input_size"]
    multi = cfg["mode"] == "multi-level"
    extra = ({} if not cfg.get("warper") else
             {"warper_num_layers": cfg["warper_num_layers"],
              "warper_norm": cfg["warper_norm"]})
    return TrainConfig(
        source_only=not multi, level="multi-level" if multi else "single-level",
        warper=bool(cfg.get("warper")), input_size=f"{w},{h}",
        input_size_target=f"{w},{h}", compute_dtype=cfg["compute_dtype"],
        restore_from="", random_seed=int(seed) % (1 << 31),
        batch_size=batch_size,
        num_classes=cfg["num_classes"], learning_rate=cfg["learning_rate"],
        learning_rate_D=cfg.get("learning_rate_D", 1e-4),
        momentum=cfg["momentum"], weight_decay=cfg["weight_decay"],
        power=cfg["power"], num_steps=cfg["num_steps"],
        lambda_seg=cfg.get("lambda_seg", 0.1),
        lambda_adv_target1=cfg.get("lambda_adv_target1", 2e-4),
        lambda_adv_target2=cfg.get("lambda_adv_target2", 1e-3),
        gan=cfg.get("gan", "LS"), bn_mode=cfg["bn"], **extra)


def cut_depth(model: torch.nn.Module, blocks) -> None:
    """Keep the first `blocks[i]` blocks of each stage: the program builds
    ResNet-101's (3, 4, 23, 3); a configuration of another depth cuts it."""
    for i, n in enumerate(blocks, start=1):
        stage = getattr(model, f"layer{i}")
        if len(stage) != n:
            setattr(model, f"layer{i}", stage[:n])


def build_train(cfg: dict, seed: int, weights: dict, device, batch_size: int):
    """(state, step) with `weights` ({module: state dict}) loaded;
    `batch_size` is the global batch (over the group's ranks)."""
    tc = train_config(cfg, seed, batch_size)
    state = build_train_state(tc, device)
    cut_depth(state.model, cfg["blocks"])
    for module, attr in MODULES.items():
        if module in weights:
            getattr(state, attr).load_state_dict(weights[module])
    if tc.source_only:
        step = make_source_only_step(tc.input_hw)
    else:
        step = make_adversarial_step(
            level=tc.level, gan=tc.gan, lambda_seg=tc.lambda_seg,
            lambda_adv1=tc.lambda_adv_target1,
            lambda_adv2=tc.lambda_adv_target2, input_hw=tc.input_hw)
    return state, step


def build_eval(cfg: dict, weights: dict, device):
    """The bf16 eval function (images, labels) -> (masks, histogram) over
    the program's DeeplabMulti with `weights['G']`."""
    from adaptsegnet_tpu_torch.eval.evaluator import make_eval_hist_fn
    from adaptsegnet_tpu_torch.models import DeeplabMulti

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["compute_dtype"]]
    model = DeeplabMulti(num_classes=cfg["num_classes"], dtype=dtype,
                         device=device)
    cut_depth(model, cfg["blocks"])
    model.load_state_dict(weights["G"])
    model.eval()
    return model, make_eval_hist_fn(
        model, out_hw=tuple(cfg["eval_output_size"]),
        num_classes=cfg["num_classes"], dtype=dtype)


def step_batch(batch: dict) -> dict:
    """The step's layout: (iter_size 1, B, ...)."""
    return {k: v.unsqueeze(0) for k, v in batch.items()}


def trainable(state) -> dict:
    """{module: {name: parameter}} of the parameters the optimizers own."""
    out = {}
    for module, attr in MODULES.items():
        m = getattr(state, attr)
        if m is not None and module != "W":
            out[module] = {n: p for n, p in m.named_parameters()
                           if p.requires_grad}
    return out


@torch.no_grad()
def first_gradients(state, start: dict, cfg: dict) -> dict:
    """{module: {leaf: gradient}} (float32, on the host) of the first
    step's gradient as each optimizer got it, from its state after that
    step: SGD's momentum buffer is grad + weight_decay * p0 on its first
    step, Adam's first moment (1 - beta1) grad. `start`: the weights
    before the step."""
    opts = {"G": state.g_opt, "D1": state.d1_opt, "D2": state.d2_opt}
    out = {}
    for module, params in trainable(state).items():
        opt = opts[module]
        grads = {}
        for name, p in params.items():
            st = opt.state.get(p, {})
            if "momentum_buffer" in st:
                p0 = start[module][name].to(p.device)
                g = st["momentum_buffer"] - cfg["weight_decay"] * p0
            elif "exp_avg" in st:
                g = st["exp_avg"] / (1.0 - opt.param_groups[0]["betas"][0])
            else:
                continue  # no state: the optimizer did not step
            grads[name] = g.float().cpu()
        out[module] = grads
    return out


@torch.no_grad()
def changes(state, start: dict) -> dict:
    """{module: {leaf: norm of p - p0}} of the trainable parameters."""
    return {module: {n: float(torch.linalg.vector_norm(
        p.float() - start[module][n].to(p.device))) for n, p in params.items()}
        for module, params in trainable(state).items()}


@torch.no_grad()
def warper_stats(state, start: dict) -> dict:
    """{buffer: norm of its change} of the Warper's running statistics."""
    if state.warper is None:
        return {}
    return {n: float(torch.linalg.vector_norm(b.float() - start["W"][n].to(b.device)))
            for n, b in state.warper.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def reset_launches() -> None:
    kernels.reset_launch_counts()


def launches() -> dict:
    return kernels.launch_counts()
