"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on the card unless asked for the CPU, and
``chip_smoke.py`` refuses to run without a CUDA device."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.device import resolve_device
from repro_torch.interop import tensors_from_numpy, to_tensor
from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.examples import layout_reorg_demo
from repro_torch.io import Dataset, StagingExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules() -> list:
    names = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_import_leaves_jax_and_repro_unloaded():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k in ('jax', 'ml_dtypes')"
            " or k == 'repro' or k.startswith(('jax.', 'repro.')))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("mod", ["core.cost_model", "core.reorg",
                                 "core.read_patterns", "io.patterns",
                                 "io.reader", "io.engine", "core.policy",
                                 "io.staging", "checkpoint.async_ckpt"])
def test_mirrored_modules_are_scanned(mod):
    """The port keeps its own copy of each module it mirrors, at the same
    path, and the scans above cover it."""
    rel = pathlib.Path(*mod.split(".")).with_suffix(".py")
    assert (ROOT / "src" / "repro" / rel).is_file()
    assert PKG / rel in SOURCES
    assert f"repro_torch.{mod}" in _modules()


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_package_is_lazy():
    assert set(repro_torch.__all__) == {"checkpoint", "configs", "core",
                                        "data", "device", "examples",
                                        "interop", "io", "kernels", "launch",
                                        "models", "serve", "train"}
    with pytest.raises(AttributeError):
        repro_torch.no_such_module


def test_entry_points_need_a_gpu_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Dataset.create(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensors_from_numpy({0: np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StagingExecutor(str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncCheckpointer(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        layout_reorg_demo.main(["--tiny"])
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    assert Dataset.create(str(tmp_path / "e"), device="cpu").device.type \
        == "cpu"
    assert to_tensor(np.ones(2, np.int8), "cpu").dtype == torch.int8


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a CUDA device — and copied out of the repository — the
    script exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / script.name))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
