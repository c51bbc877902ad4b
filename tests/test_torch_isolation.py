"""The port stands alone: no JAX, nothing of adaptsegnet_tpu, and no silent
CPU fallback at its entry points."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import adaptsegnet_tpu_torch
from adaptsegnet_tpu_torch.cli import evaluate as cli_evaluate
from adaptsegnet_tpu_torch.cli import train as cli_train
from adaptsegnet_tpu_torch.models import (
    DeeplabMulti,
    DeeplabSingle,
    DeeplabVGG,
    FCDiscriminator,
    ResNetBackbone,
    Warper,
)

PKG_DIR = pathlib.Path(adaptsegnet_tpu_torch.__file__).parent
REPO = PKG_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "adaptsegnet_tpu")


def _module_names():
    for path in sorted(PKG_DIR.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    code = "\n".join([
        "import importlib, sys",
        *[f"sys.modules[{name!r}] = None" for name in FORBIDDEN],
        f"for name in {list(_module_names())!r}:",
        "    importlib.import_module(name)",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('imported', len([m for m in sys.modules "
        "if m.startswith('adaptsegnet_tpu_torch')]))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def _assert_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("path", sorted(PKG_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG_DIR)))
def test_no_forbidden_import_in_source(path):
    _assert_no_forbidden_import(path)


def test_new_modules_are_covered():
    """The modules of the single-head and VGG families, the Synscapes source
    and the logger, the data-parallel group, the profiler and its CLI and
    the entry point are among those the import and source checks walk."""
    names = set(_module_names())
    for mod in ("models.deeplab_vgg", "data.synscapes", "utils.logging",
                "ops.conv3x3", "ops.kernels.conv3x3_dil", "train.optim",
                "parallel", "parallel.group", "utils.profiling",
                "cli.profile_step", "entry"):
        assert f"adaptsegnet_tpu_torch.{mod}" in names


def test_cli_modes_import_no_jax(tmp_path):
    """Building every model family and train-flag state through the CLIs'
    build functions, in a process where importing jax, flax, optax or the JAX
    package fails, leaves none of them loaded."""
    code = "\n".join([
        "import sys",
        *[f"sys.modules[{name!r}] = None" for name in FORBIDDEN],
        "import argparse, torch",
        "from adaptsegnet_tpu_torch.cli import evaluate",
        "from adaptsegnet_tpu_torch.train.build import build_train_state",
        "from adaptsegnet_tpu_torch.train.config import parse_args, world_size",
        "from adaptsegnet_tpu_torch import entry",
        "from adaptsegnet_tpu_torch.cli import profile_step",
        "from adaptsegnet_tpu_torch.utils import profiling",
        "from adaptsegnet_tpu_torch.data import SynscapesDataset",
        "from adaptsegnet_tpu_torch.utils.logging import ScalarLogger",
        "cpu = torch.device('cpu')",
        "for name in ('Oracle', 'DeeplabVGG'):",
        "    evaluate.build_model(argparse.Namespace(model=name, "
        "num_classes=19, aspp_sum=''), cpu)",
        "for flags in (['--bn-mode', 'batch'], ['--optim-dup-quirk'], "
        "['--model', 'DeeplabVGG', '--no-source-only'], "
        "['--source', 'Synscapes', '--tensorboard']):",
        "    build_train_state(parse_args(['--no-warper', '--restore-from', "
        "'', *flags]), cpu)",
        "cfg = parse_args(['--no-warper', '--restore-from', '', "
        "'--num-devices', '2', '--batch-size', '2', '--cpu'])",
        "assert world_size(cfg) == 2",
        "build_train_state(cfg, cpu)",
        "ScalarLogger(None, False).close()",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('built')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "built" in proc.stdout


def test_chip_smoke_imports_no_jax():
    _assert_no_forbidden_import(REPO / "chip_smoke.py")


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeeplabMulti()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNetBackbone(layers=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeeplabMulti(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FCDiscriminator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_evaluate.main(["--restore-from", "unused.pth",
                           "--save", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Warper()
    for cls in (DeeplabSingle, DeeplabVGG):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
    for name in ("Oracle", "DeeplabVGG"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_evaluate.main(["--model", name, "--restore-from", "unused.pth",
                               "--save", str(tmp_path / "out")])
    for flags in (["--bn-mode", "batch"], ["--optim-dup-quirk"],
                  ["--source", "Synscapes"],
                  ["--model", "DeeplabVGG", "--no-source-only"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_train.main(["--no-warper", *flags, "--restore-from", "",
                            "--snapshot-dir", str(tmp_path / "snap")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--no-warper", "--restore-from", "",
                        "--snapshot-dir", str(tmp_path / "snap")])
    with pytest.raises(RuntimeError, match="no CUDA device"):  # default mode
        cli_train.main(["--restore-from", "",
                        "--snapshot-dir", str(tmp_path / "snap")])
    assert next(ResNetBackbone(layers=(1, 1, 1, 1), device="cpu")
                .parameters()).device.type == "cpu"


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (REPO, alone):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0, proc.stdout
        assert '"ok": true' not in proc.stdout
