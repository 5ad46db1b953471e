"""Isolation and device rules of the PyTorch/CUDA port (mxnet_tpu_torch):
it imports neither JAX nor the JAX package, builds nothing at import, and
never carries on quietly on the CPU when CUDA was wanted."""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


class LazyModule:
    """A module, or an attribute of one, imported at its first use.

    The port's test files name the reference (JAX and the JAX package)
    through these instead of importing it at their top: the import then runs
    inside the tests that compare against the reference, and the files'
    ``cuda``-marked tests collect and run on a machine without JAX."""

    def __init__(self, module: str, attr: Optional[str] = None):
        self._module, self._attr = module, attr

    def _target(self):
        mod = importlib.import_module(self._module)
        return mod if self._attr is None else getattr(mod, self._attr)

    def __getattr__(self, name):
        return getattr(self._target(), name)

    def __call__(self, *args, **kwargs):
        return self._target()(*args, **kwargs)


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
            "mxnet_tpu_torch/config.py", "mxnet_tpu_torch/autograd.py",
            "mxnet_tpu_torch/initializer.py", "mxnet_tpu_torch/ops/nn.py",
            "mxnet_tpu_torch/gluon/block.py",
            "mxnet_tpu_torch/gluon/parameter.py",
            "mxnet_tpu_torch/gluon/trainer.py",
            "mxnet_tpu_torch/gluon/loss.py",
            "mxnet_tpu_torch/gluon/nn/basic_layers.py",
            "mxnet_tpu_torch/gluon/nn/conv_layers.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/resnet.py",
            "mxnet_tpu_torch/optimizer/sgd.py",
            "mxnet_tpu_torch/base.py",
            "mxnet_tpu_torch/contrib/quantization.py",
            "mxnet_tpu_torch/program_store.py",
            "mxnet_tpu_torch/cached_step.py",
            "mxnet_tpu_torch/serving.py",
            "mxnet_tpu_torch/ops/optimizer.py",
            "mxnet_tpu_torch/parallel/mesh.py",
            "mxnet_tpu_torch/parallel/train.py",
            "mxnet_tpu_torch/random.py",
            "mxnet_tpu_torch/ndarray/__init__.py",
            "mxnet_tpu_torch/ndarray/ndarray.py",
            "mxnet_tpu_torch/ndarray/register.py",
            "mxnet_tpu_torch/ndarray/_unported.py",
            "mxnet_tpu_torch/ops/registry.py",
            "mxnet_tpu_torch/ops/elemwise.py",
            "mxnet_tpu_torch/ops/tensor.py",
            "mxnet_tpu_torch/ops/reduce.py",
            "mxnet_tpu_torch/ops/init.py",
            "mxnet_tpu_torch/ops/random.py",
            "mxnet_tpu_torch/optimizer/adam.py",
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted({m for m in _imports(path) if _forbidden(m)})
    assert not bad, f"{path.name} imports {bad}"


PORT_TEST_FILES = sorted((ROOT / "tests").glob("test_torch_*.py"))


@pytest.mark.parametrize("path", PORT_TEST_FILES, ids=lambda p: p.name)
def test_port_tests_import_no_reference_at_their_top(path):
    """The port's test files import JAX and the JAX package only inside the
    tests that compare (through ``LazyModule``), never at their top."""
    tree = ast.parse(path.read_text(), str(path))
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            top.add(node.module)
    bad = sorted(m for m in top if _forbidden(m))
    assert not bad, f"{path.name} imports {bad} at its top"


_COLLECT_WITHOUT_JAX = r"""
import sys
for name in ("jax", "jaxlib", "mxnet_tpu"):
    sys.modules[name] = None          # import raises ImportError
import pytest
sys.exit(pytest.main(sys.argv[1:]))
"""


def test_port_cuda_tests_collect_without_jax():
    """Where JAX is missing, as on a GPU machine set up for the port alone,
    every port test file still collects, with its cuda-marked tests."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _COLLECT_WITHOUT_JAX, "--collect-only", "-q",
         "--noconftest", "-p", "no:cacheprovider", "-m", "cuda",
         *(str(p) for p in PORT_TEST_FILES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    collected = [ln for ln in out.stdout.splitlines() if "::" in ln]
    files = {ln.split("::")[0].split("/")[-1] for ln in collected}
    assert {"test_torch_quantization.py", "test_torch_flash_attention.py",
            "test_torch_ndarray.py",
            "test_torch_conv_bn_epilogue.py", "test_torch_conv_bn_stats.py",
            "test_torch_cached_step.py", "test_torch_train_step.py"} <= files, \
        out.stdout[-3000:]


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
m, v = models.init_opt_state(p)
step = models.make_train_step(cfg, device="cpu")
p, m, v, loss = step(p, m, v, np.zeros((1, 8), np.int64),
                     np.ones((1, 8), np.int64), 1)
assert loss.dim() == 0
from mxnet_tpu_torch import autograd, cpu, gluon
net = gluon.model_zoo.get_model("resnet18_v1", classes=4, layout="NHWC",
                                input_layout="NHWC", ctx=cpu())
net.initialize()
import torch
net(torch.zeros((1, 32, 32, 3)))
net.hybridize()
trainer = gluon.Trainer(net.collect_params(), "sgd", {"momentum": 0.9})
with autograd.record():
    out = net(torch.zeros((2, 32, 32, 3)))
autograd.backward(gluon.loss.SoftmaxCrossEntropyLoss()(out, torch.ones(2)))
trainer.step(2)
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
    with pytest.raises(RuntimeError, match="CUDA"):
        models.make_train_step(cfg)
    assert resolve_device("cpu") == torch.device("cpu")


def test_gluon_entry_points_raise_without_cuda(no_cuda):
    from mxnet_tpu_torch import cpu, gluon
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    kw = dict(classes=10, layout="NHWC", input_layout="NHWC")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("resnet50_v1", **kw)
    net = get_model("resnet18_v1", ctx=cpu(), **kw)
    net.initialize()                    # the net's device: the CPU
    assert net.collect_params()["output.bias"].device.type == "cpu"
    dense = gluon.nn.Dense(4, in_units=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        dense.initialize()
    with pytest.raises(RuntimeError, match="CUDA"):
        gluon.Trainer(dense.collect_params(), "sgd")
    dense.initialize(ctx=cpu())
    gluon.Trainer(dense.collect_params(), "sgd")
