"""The port stands alone and never falls back.

* no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package ``repro`` (an AST scan);
* an entry point given no device raises when PyTorch sees no GPU;
* the kernel wrapper raises on tensors its kernel cannot take (the CUDA
  cases themselves run in ``tests/test_torch_cuda.py`` on a GPU host);
* ``chip_smoke.py`` exits non-zero, printing no result, without a GPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core.model import ConvLayer
from repro_torch.core.serving import ServingEngine
from repro_torch.kernels import build
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.models.layers import TrimCNN

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPO = [ConvLayer("a", 8, 3, 4, 3, padding=1)]


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_no_device_means_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TrimCNN.random(TOPO, n_classes=2, device="cpu")
    with pytest.raises(RuntimeError, match="GPU"):
        ServingEngine.for_topology(TOPO, model, buckets=(1,))
    with pytest.raises(RuntimeError, match="GPU"):
        TrimCNN.random(TOPO, n_classes=2)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    x = torch.zeros((1, 8, 8, 4))
    w = torch.zeros((3, 3, 4, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tc.trim_conv2d(x.to("meta"), w.to("meta"))
    with pytest.raises(TypeError):
        tc.trim_conv2d(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        tc.trim_conv2d(x.permute(0, 2, 1, 3), w)
    with pytest.raises(ValueError, match="bias"):
        tc.trim_conv2d(x, w, torch.zeros(3))
    with pytest.raises(ValueError, match="square"):
        tc.trim_conv2d(x, torch.zeros((3, 1, 4, 4)))
    with pytest.raises(ValueError, match="shared memory"):
        tc.trim_conv2d(torch.zeros((1, 4, 4, 8192)),
                       torch.zeros((3, 3, 8192, 1)))
    with pytest.raises(NotImplementedError, match="backward"):
        tc.trim_conv2d(x, w.requires_grad_())


def test_plain_path_does_not_count_launches():
    tc.reset_launch_counts()
    tc.trim_conv2d(torch.ones((1, 6, 6, 2)), torch.ones((3, 3, 2, 2)),
                   pad=1, dataflow="halo")
    assert tc.LAUNCHES == {"carry": 0, "halo": 0}


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "GPU" in out.stderr
