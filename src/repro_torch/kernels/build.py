"""Build and bind the port's CUDA kernels.

Every kernel source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build runs at first use, into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``); a library's file name carries a hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
never served by a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# C entry points of each source: name -> argument types (restype c_int)
_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_int64, ctypes.c_float
_CONV_ARGS = [_P, _P, _P, _P] + [_I] * 20 + [_P]
_CONV_BF16_ARGS = [_P, _P, _P, _P] + [_I] * 23 + [_P]   # + route, warps
_Q8_ARGS = [_P] * 5 + [_I] * 24 + [_P]
_WGRAD_ARGS = [_P, _P, _P, _P] + [_I] * 17 + [_P]
_FUSED_ARGS = [_P, _P, _P, _P, _I, _P]
_FUSED_BF16_ARGS = [_P, _P, _P, _P, _P, _I, _P]   # + the stages' routes
_ATTN_ARGS = [_P] * 5 + [_I] * 6 + [_L] * 12 + [_I, _I, _F, _F, _P]
_ATTN_BWD_ARGS = [_P] * 8 + [_I] * 6 + [_L] * 12 + [_I, _I, _F, _F, _I, _P]
_CONV1D_ARGS = [_P] * 3 + [_I] * 4 + [_L] * 4 + [_I, _I, _I, _P]
_CONV1D_WGRAD_ARGS = [_P] * 4 + [_I] * 4 + [_L] * 4 + [_I, _I, _I, _P]
SOURCES = {
    "trim_conv2d": {"trim_conv2d_carry": _CONV_ARGS,
                    "trim_conv2d_halo": _CONV_ARGS,
                    "trim_conv2d_carry_bf16": _CONV_BF16_ARGS,
                    "trim_conv2d_halo_bf16": _CONV_BF16_ARGS},
    "trim_conv2d_q8": {"trim_conv2d_q8_carry": _Q8_ARGS,
                       "trim_conv2d_q8_halo": _Q8_ARGS},
    "trim_conv2d_wgrad": {"trim_conv2d_wgrad": _WGRAD_ARGS,
                          "trim_conv2d_wgrad_bf16": _WGRAD_ARGS,
                          "trim_conv2d_wgrad_resident_blocks": [_I, _P],
                          "trim_conv2d_wgrad_mma_resident_blocks":
                              [_I, _P]},
    "trim_conv2d_fused": {"trim_conv2d_fused": _FUSED_ARGS,
                          "trim_conv2d_fused_bf16": _FUSED_BF16_ARGS},
    "flash_attention": {"flash_attention_f32": _ATTN_ARGS,
                        "flash_attention_bf16": _ATTN_ARGS},
    "flash_attention_bwd": {"flash_attention_bwd_dkdv_f32": _ATTN_BWD_ARGS,
                            "flash_attention_bwd_dq_f32": _ATTN_BWD_ARGS,
                            "flash_attention_bwd_sum_f32":
                                [_P, _P, _P, _L, _I, _I, _P],
                            "flash_attention_bwd_dkdv_bf16": _ATTN_BWD_ARGS,
                            "flash_attention_bwd_dq_bf16": _ATTN_BWD_ARGS,
                            "flash_attention_bwd_sum_bf16":
                                [_P, _P, _P, _L, _I, _I, _P]},
    "trim_conv1d": {"trim_conv1d_f32": _CONV1D_ARGS,
                    "trim_conv1d_bf16": _CONV1D_ARGS},
    "trim_conv1d_wgrad": {"trim_conv1d_wgrad_f32": _CONV1D_WGRAD_ARGS,
                          "trim_conv1d_wgrad_bf16": _CONV1D_WGRAD_ARGS},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds", "command", "ptxas": each instance's name, registers
# and spills as ptxas reports them}
build_log: dict[str, dict] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's kernels are built on the GPU host")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers too: an edited epilogue must rebuild every source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SOURCES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def build_all(*, rebuild: bool = False) -> dict[str, ctypes.CDLL]:
    """Compile every source that has no current library (all of them with
    ``rebuild``), one ``nvcc`` per source, all started together; then
    load and bind each.  Raises ``RuntimeError`` with the compiler's
    output when a build fails."""
    with _lock:
        todo = [n for n in SOURCES
                if rebuild or (n not in _libs and not _target(n).exists())]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {}
            t0 = time.perf_counter()
            for name in todo:
                out = _target(name)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (cmd, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (cmd, tmp, proc) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{' '.join(cmd)}\n{log}")
                    continue
                os.replace(tmp, _target(name))
                build_log[name] = {
                    "seconds": time.perf_counter() - t0,
                    "command": " ".join(cmd),
                    "ptxas": [ln for ln in log.splitlines()
                              if "entry function" in ln
                              or "registers" in ln or "spill" in ln]}
                _libs.pop(name, None)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in SOURCES:
            if name not in _libs:
                _libs[name] = _bind(name, _target(name))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The bound library of one source, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]
