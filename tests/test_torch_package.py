"""Isolation and device rules of the PyTorch/CUDA port (mxnet_tpu_torch):
it imports neither JAX nor the JAX package, builds nothing at import, and
never carries on quietly on the CPU when CUDA was wanted."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _forbidden(module: str) -> bool:
    # exact package match: "mxnet_tpu_torch" is allowed, "mxnet_tpu" and
    # "mxnet_tpu.ops" are not
    return module.split(".")[0] in FORBIDDEN


def _imports(path: Path):
    """Absolute module names imported by ``path``, relative imports
    resolved against its package."""
    rel = path.relative_to(ROOT).with_suffix("")
    pkg = list(rel.parts[:-1])
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"


def test_scan_finds_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"mxnet_tpu_torch/__init__.py", "mxnet_tpu_torch/context.py",
            "mxnet_tpu_torch/ops/cuda_kernels.py",
            "mxnet_tpu_torch/models/transformer_lm.py",
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted({m for m in _imports(path) if _forbidden(m)})
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("module,bad", [
    ("mxnet_tpu_torch", False), ("mxnet_tpu_torch.ops", False),
    ("mxnet_tpu", True), ("mxnet_tpu.models", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib", True), ("jaxtyping", False)])
def test_forbidden_matches_exact_package(module, bad):
    assert _forbidden(module) is bad


def test_relative_imports_resolve_into_the_port():
    mods = set(_imports(ROOT / "mxnet_tpu_torch/models/transformer_lm.py"))
    assert "mxnet_tpu_torch.ops" in mods
    assert "mxnet_tpu_torch.context" in mods


_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import mxnet_tpu_torch
from mxnet_tpu_torch import models
cfg = models.TransformerLMConfig(vocab_size=64, num_layers=1, num_heads=2,
                                 hidden=16, mlp_hidden=32, max_len=16)
p = models.init_params(cfg, device="cpu")
logits, _ = models.forward(p, np.zeros((1, 8), np.int64), cfg, device="cpu")
assert logits.shape == (1, 8, 64)
from mxnet_tpu_torch.ops import _build
assert not _build._LIBS
print("jax" in sys.modules, any(m == "mxnet_tpu" or m.startswith("mxnet_tpu.")
                                for m in sys.modules))
"""


def test_import_and_cpu_forward_load_no_jax():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    out = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "False"], out.stdout


_NO_NVCC = r"""
import sys
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch.ops import _build, cuda_kernels
try:
    _build.nvcc_path()
    print("nvcc found")
except FileNotFoundError:
    print("no nvcc")
print(len(_build._LIBS))
"""


def test_importing_kernels_neither_builds_nor_needs_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_HOME")}
    env["PATH"] = str(tmp_path)            # no nvcc on PATH
    out = subprocess.run([sys.executable, "-c", _NO_NVCC, str(ROOT)],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    found, n_libs = out.stdout.split("\n")[:2]
    assert n_libs == "0"
    assert found == ("nvcc found" if Path("/usr/local/cuda/bin/nvcc")
                     .is_file() else "no nvcc")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_without_device_raise_without_cuda(no_cuda):
    from mxnet_tpu_torch import models
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.convert import params_from_numpy

    cfg = models.TransformerLMConfig(vocab_size=64, num_layers=1,
                                     num_heads=2, hidden=16, mlp_hidden=32,
                                     max_len=16, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        models.init_params(cfg)
    p = models.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.forward(p, toks, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.loss_fn(p, toks, toks, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({k: v.numpy() for k, v in p.items()}, cfg)
    assert resolve_device("cpu") == torch.device("cpu")
