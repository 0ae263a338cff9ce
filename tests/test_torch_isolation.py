"""The port stands alone and never falls back.

* no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax``, anything of the JAX package ``repro``, or ``ml_dtypes`` (JAX's
  bf16 numpy type, absent where JAX is) (an AST scan);
* an entry point given no device raises when PyTorch sees no GPU;
* the kernel wrappers (conv, fused group, flash attention, conv1d) raise on
  tensors their kernels cannot take (the CUDA cases themselves run in
  ``tests/test_torch_cuda.py`` on a GPU host), and their plain versions
  count no launch;
* ``chip_smoke.py`` exits non-zero, printing no result, without a GPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core.fuse_plan import build_group
from repro_torch.core.model import ConvLayer
from repro_torch.core.serving import ServingEngine
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import trim_conv1d as tc1
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.launch import serve
from repro_torch.kernels import trim_conv2d_fused as tfu
from repro_torch.models.layers import TrimCNN

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPO = [ConvLayer("a", 8, 3, 4, 3, padding=1)]
FUSED_TOPO = [ConvLayer("f0", 6, 2, 3, 3, padding=1),
              ConvLayer("f1", 6, 3, 2, 3, padding=1)]


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a per-test temp file: no test reads
    or writes a cache outside it."""
    from repro_torch.core import autotune
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


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
    names = {p.relative_to(ROOT / "src").as_posix() for p in files[:-1]}
    assert {"repro_torch/models/mamba.py",
            "repro_torch/kernels/trim_conv1d.py",
            "repro_torch/configs/falcon_mamba.py",
            "repro_torch/core/tiling.py",
            "repro_torch/configs/trim_cnn.py",
            "repro_torch/models/frontends.py",
            "repro_torch/core/autotune.py"} <= names
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
                (path, mod)


def test_no_device_means_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TrimCNN.random(TOPO, n_classes=2, device="cpu")
    with pytest.raises(RuntimeError, match="GPU"):
        ServingEngine.for_topology(TOPO, model, buckets=(1,))
    with pytest.raises(RuntimeError, match="GPU"):
        TrimCNN.random(TOPO, n_classes=2)


def test_lm_serve_without_a_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        serve.main(["--smoke", "--batch", "1", "--gen", "1"])


def test_mamba_serve_without_a_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--batch", "1",
                    "--gen", "1"])


def test_conv1d_wrapper_rejects_what_the_kernel_cannot_take():
    x, w = torch.zeros((2, 8, 4)), torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tc1.trim_conv1d(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="share"):
        tc1.trim_conv1d(x, w.to("meta"))
    with pytest.raises(ValueError, match="float32"):
        tc1.trim_conv1d(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous channel"):
        tc1.trim_conv1d(torch.zeros((2, 4, 8)).transpose(1, 2), w)
    with pytest.raises(ValueError, match="K=1"):
        tc1.trim_conv1d(x, w[:1])
    with pytest.raises(ValueError, match="empty"):
        tc1.trim_conv1d(torch.zeros((2, 0, 4)), w)
    # under autograd it runs the Function whose backward is the backward
    # kernels; under no_grad no graph is kept
    assert tc1.trim_conv1d(x, w.requires_grad_()).grad_fn is not None
    with torch.no_grad():
        assert tc1.trim_conv1d(x, w).grad_fn is None


def test_conv1d_plain_path_does_not_count_launches():
    tc1.reset_launch_counts()
    tc1.trim_conv1d(torch.ones((2, 9, 5)), torch.ones((3, 5)), tile_l=4)
    tc1.trim_conv1d(torch.ones((2, 9, 8), dtype=torch.bfloat16),
                    torch.ones((3, 8), dtype=torch.bfloat16))
    assert tc1.LAUNCHES == {"trim_conv1d": 0, "trim_conv1d_bf16": 0}


def test_flash_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fa.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    with pytest.raises(ValueError, match="share"):
        fa.flash_attention(q, kv.to("meta"), kv)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa.flash_attention(torch.zeros((1, 8, 16, 4)).transpose(2, 3), kv,
                           kv)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(torch.zeros((1, 8, 3, 16)), kv, kv)
    # any head_dim: D > 256 is taken (the kernel's wide-head route)
    wide = fa.flash_attention(torch.ones((1, 8, 4, 264)),
                              torch.ones((1, 8, 2, 264)),
                              torch.ones((1, 8, 2, 264)))
    assert wide.shape == (1, 8, 4, 264) and bool((wide == 1).all())
    with pytest.raises(ValueError, match="no key"):
        fa.flash_attention(torch.zeros((1, 9, 4, 16)), kv, kv)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="soft_cap"):
        fa.flash_attention(q, kv, kv, soft_cap=0.0)
    with pytest.raises(ValueError, match="Lk, Hkv"):
        fa.flash_attention(q, kv, torch.zeros((1, 9, 2, 16)))


def test_flash_plain_path_does_not_count_launches():
    fa.reset_launch_counts()
    fa.flash_attention(torch.ones((1, 5, 4, 8)), torch.ones((1, 7, 2, 8)),
                       torch.ones((1, 7, 2, 8)), soft_cap=5.0, window=3)
    fa.flash_attention(*(torch.ones(s, dtype=torch.bfloat16) for s in (
        (1, 5, 4, 8), (1, 7, 2, 8), (1, 7, 2, 8))))
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bf16": 0}


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
    # the f32 kernel takes rectangular (KH x KW) sub-kernels; the int8
    # kernel stays square
    assert tc.trim_conv2d(x, torch.zeros((3, 1, 4, 4))).shape == (1, 6, 8, 4)
    with pytest.raises(ValueError, match="square"):
        tc.trim_conv2d_q8(x.to(torch.int8),
                          torch.zeros((3, 1, 4, 4), dtype=torch.int8), None,
                          torch.ones(4))
    with pytest.raises(ValueError, match="shared memory"):
        tc.trim_conv2d(torch.zeros((1, 4, 4, 8192)),
                       torch.zeros((3, 3, 8192, 1)))
    # operands that require grad are taken; the wrapper itself is not
    # differentiable (ops.conv2d's autograd Function is)
    assert tc.trim_conv2d(x, w.requires_grad_()).grad_fn is None
    g = torch.zeros((1, 6, 6, 4))
    with pytest.raises(ValueError, match="cotangent"):
        tc.trim_conv2d_weight_grad(x, g, kernel_size=3, pad=0, stride=2)
    with pytest.raises(ValueError, match="cotangent"):
        tc.trim_conv2d_input_grad(g, w, x_shape=(1, 8, 8, 4), stride=2)
    with pytest.raises(TypeError):
        tc.trim_conv2d_weight_grad(x.double(), g.double(), kernel_size=3)


def test_fused_wrapper_rejects_what_the_kernel_cannot_take():
    g = build_group(FUSED_TOPO, 0, n=1, strip_rows=2, band_cols=2)
    x = torch.zeros((1, 6, 6, 2))
    ws = [torch.zeros((3, 3, 2, 3)), torch.zeros((3, 3, 3, 2))]
    bs = [torch.zeros(3), torch.zeros(2)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfu.trim_conv2d_fused(x.to("meta"), [w.to("meta") for w in ws],
                              [None, None], group=g)
    with pytest.raises(ValueError, match="share"):
        tfu.trim_conv2d_fused(x, [ws[0], ws[1].to("meta")], bs, group=g)
    with pytest.raises(TypeError):
        tfu.trim_conv2d_fused(x.double(), ws, bs, group=g)
    with pytest.raises(ValueError, match="contiguous"):
        tfu.trim_conv2d_fused(
            x, [ws[0], torch.zeros((3, 3, 2, 3)).transpose(2, 3)], bs,
            group=g)
    with pytest.raises(ValueError, match="stage-0"):
        tfu.trim_conv2d_fused(torch.zeros((2, 6, 6, 2)), ws, bs, group=g)
    with pytest.raises(ValueError, match="planned"):
        tfu.trim_conv2d_fused(x, ws[::-1], bs, group=g)
    # the wrapper itself is not differentiable (fused_group_apply is)
    assert tfu.trim_conv2d_fused(
        x, [w.requires_grad_() for w in ws], bs, group=g).grad_fn is None


def test_plain_path_does_not_count_launches():
    tc.reset_launch_counts()
    tc.trim_conv2d(torch.ones((1, 6, 6, 2)), torch.ones((3, 3, 2, 2)),
                   pad=1, dataflow="halo")
    tc.trim_conv2d_weight_grad(torch.ones((1, 6, 6, 2)),
                               torch.ones((1, 6, 6, 2)), kernel_size=3, pad=1)
    tc.trim_conv2d_input_grad(torch.ones((1, 6, 6, 2)),
                              torch.ones((3, 3, 2, 2)), x_shape=(1, 6, 6, 2),
                              pad=1)
    tfu.fused_group_apply(
        torch.ones((1, 6, 6, 2)),
        [torch.ones((3, 3, 2, 3)), torch.ones((3, 3, 3, 2))], [None, None],
        group=build_group(FUSED_TOPO, 0, n=1, strip_rows=2))
    for df in ("carry", "halo"):
        tc.trim_conv2d_q8(torch.ones((1, 6, 6, 2), dtype=torch.int8),
                          torch.ones((3, 3, 2, 2), dtype=torch.int8), None,
                          torch.ones(2), zero_point=3, pad=1, dataflow=df)
        tc.trim_conv2d(torch.ones((1, 6, 6, 2), dtype=torch.bfloat16),
                       torch.ones((3, 3, 2, 2), dtype=torch.bfloat16),
                       pad=1, dataflow=df)
    tfu.fused_group_apply(
        torch.ones((1, 6, 6, 2), dtype=torch.bfloat16),
        [torch.ones((3, 3, 2, 3), dtype=torch.bfloat16),
         torch.ones((3, 3, 3, 2), dtype=torch.bfloat16)], [None, None],
        group=build_group(FUSED_TOPO, 0, n=1, strip_rows=2, dtype_bytes=2))
    tc.trim_conv2d_weight_grad(torch.ones((1, 6, 6, 2), dtype=torch.bfloat16),
                               torch.ones((1, 6, 6, 2), dtype=torch.bfloat16),
                               kernel_size=3, pad=1)
    assert tc.LAUNCHES == {"carry": 0, "halo": 0, "wgrad": 0, "fused": 0,
                           "q8_carry": 0, "q8_halo": 0, "carry_bf16": 0,
                           "halo_bf16": 0, "fused_bf16": 0, "wgrad_bf16": 0}


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
