"""The bf16 weight-gradient and flash-attention kernels on the bf16 tensor
cores, on the CPU.

The bf16 entry of the weight-gradient kernel (``trim_conv2d_wgrad_bf16``)
takes route ``"mma"`` where Cin/g is a multiple of 16 and Cout/g of 8: a
GEMM on ``mma.sync`` m16n8k16 over the chunk's positions, in the order
stated atop ``csrc/trim_conv2d_wgrad.cu``; other layers keep the FFMA
kernel (``"gemm"``, ``"depthwise"``).  The flash kernel's bf16 narrow
route runs Q K^T and P V on the same instruction, P split into bf16 hi and
lo halves.  The kernels run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``); what is checked here is everything around
them:

* ``wgrad_route`` over VGG-16, AlexNet (its K 11 sub-kernels too),
  ResNet-18, U-Net, a depthwise layer and the stem, f32 and bf16;
* the route-mma plan: chunks a pure function of the shape from the
  bf16-rate time model, the workspace within the cap, tiles and stages
  as the kernel divides them, shared memory and conflict-free pitches;
* the ``WGRAD_*`` / ``WgradRoute`` constants and the flash narrow route's
  geometry and shared memory per Dp against the ``.cu`` (parsed);
* the P split's error budget, and the card's float64 gate on the
  narrow route on its arithmetic emulated: the split passes, one bf16 P
  fails; the plain forward in float64 (the gate's oracle); the same for
  the bf16 backward (``chip_smoke.flash_bwd_bf16_emulated``): the P and
  dS splits pass, one bf16 P or dS fails;
* the tuner: bf16 wgrad records name their route, and one of the FFMA
  kernel's design is never read as an mma plan.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import autotune
from repro_torch.core import conv_plan as cp
from repro_torch.core.conv_plan import WeightGradPlan, wgrad_route
from repro_torch.core.model import alexnet_layers, vgg16_layers
from repro_torch.core.netplan import graph_nodes
from repro_torch.core.tiling import subkernel_decomposition
from repro_torch.kernels.ref import conv_pads

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
# the flash forward's narrow route, as its launcher instantiates it:
# padded head dim Dp -> (warps, keys a tile); a block holds 16 query rows
# a warp and two ring stages of K and V tiles, rows of Dp + 16 bytes
FLASH_NARROW = {64: (8, 64), 128: (8, 64), 256: (4, 32)}
FLASH_ROW_PAD_BYTES = 16


def flash_narrow_smem_bytes(dp: int, elem_bytes: int) -> int:
    warps, keys = FLASH_NARROW[dp]
    return ((16 * warps + 4 * keys)
            * (dp + FLASH_ROW_PAD_BYTES // elem_bytes) * elem_bytes)


def wgrad_mma_smem_bytes(tile_cout: int) -> int:
    """Route mma's ring: stages of bf16 x and cotangent rows, each pitched
    ``WGRAD_MMA_PITCH_PAD`` past its width."""
    return (cp.WGRAD_MMA_STAGES * cp.WGRAD_MMA_POSITIONS * 2
            * (cp.WGRAD_MMA_TILE_ROWS + tile_cout
               + 2 * cp.WGRAD_MMA_PITCH_PAD))


@pytest.fixture(autouse=True)
def _port_convtune_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a per-test temp file."""
    monkeypatch.setenv(autotune.CACHE_ENV,
                       str(tmp_path / "torch_convtune.json"))
    autotune.reset_memory_cache()
    yield
    autotune.reset_memory_cache()


def _problem(layer, n):
    pads = conv_pads(layer.ifmap, layer.ifmap, layer.kernel, layer.stride,
                     "same" if layer.padding else "valid")
    return ((n, layer.ifmap, layer.ifmap, layer.in_channels),
            (layer.kernel, layer.kernel, layer.in_channels // layer.groups,
             layer.out_channels), pads)


def _constexprs(path, known=None) -> dict:
    """The namespace-scope ``constexpr int``s of a source, evaluated
    (``known``: those of the headers it includes)."""
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 path.read_text(), re.M):
        found[name] = eval(expr, {"__builtins__": {}},
                           {**(known or {}), **found})
    return found


# ---------------------------------------------------------------------------
# the weight gradient's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net,want", [
    ("vgg16", ["gemm"] + ["mma"] * 12),
    ("alexnet", ["gemm"] + ["mma"] * 4),
])
def test_wgrad_route_of_the_networks(net, want):
    """bf16: the first conv (Cin 3) keeps the FFMA kernel, the rest run
    on the tensor cores; f32 never does."""
    layers = vgg16_layers() if net == "vgg16" else alexnet_layers()
    for dtype_bytes, routes in ((2, want), (4, ["gemm"] * len(want))):
        got = []
        for l in layers:
            xs, ws, pads = _problem(l, 2)
            plan = WeightGradPlan.build(xs, ws, stride=l.stride, pad=pads,
                                        groups=l.groups,
                                        dtype_bytes=dtype_bytes)
            assert plan.route == wgrad_route(l.in_channels, l.out_channels,
                                             l.groups, dtype_bytes)
            got.append(plan.route)
        assert got == routes


def test_wgrad_route_of_sub_kernels_depthwise_stem_and_narrow_groups():
    """AlexNet conv1's rectangular sub-kernels and the 7x7/2 stem (Cin 3)
    and the depthwise layer keep their routes in bf16; Cin/g 16 with
    Cout/g not a multiple of 8, or Cin/g 8, 24 stay on gemm."""
    for _, _, kh, kw in subkernel_decomposition(11, native_k=3):
        plan = WeightGradPlan.build((8, 227, 227, 3), (kh, kw, 3, 96),
                                    stride=4, dtype_bytes=2)
        assert plan.route == "gemm"
    stem = WeightGradPlan.build((8, 224, 224, 3), (7, 7, 3, 64), stride=2,
                                pad=3, dtype_bytes=2)
    assert stem.route == "gemm"
    dw = WeightGradPlan.build((8, 112, 112, 32), (3, 3, 1, 32), pad=1,
                              groups=32, dtype_bytes=2)
    assert dw.route == "depthwise"
    assert wgrad_route(16, 16, 16, 2) == "depthwise"
    assert [wgrad_route(c, 64, 1, 2) for c in (8, 24, 40)] == ["gemm"] * 3
    assert [wgrad_route(16, c, 1, 2) for c in (12, 20, 100)] == ["gemm"] * 3
    assert [wgrad_route(c, 8, 1, 2) for c in (16, 32, 512)] == ["mma"] * 3
    assert wgrad_route(64, 32, 2, 2) == "mma"           # per group: 32, 16
    assert wgrad_route(64, 24, 2, 2) == "gemm"          # Cout/g 12


@pytest.mark.parametrize("graph", ["resnet18", "unet"])
def test_wgrad_route_of_the_graphs(graph):
    """ResNet-18's and U-Net's convs past their Cin-3 stems (1x1/2
    projections and the 1x1 head included) run on the tensor cores where
    Cout is a multiple of 8."""
    convs = [nd.layer for nd in graph_nodes(graph) if nd.op == "conv"]
    routes = [wgrad_route(l.in_channels, l.out_channels, l.groups, 2)
              for l in convs]
    assert routes[0] == "gemm" and convs[0].in_channels == 3
    for l, r in zip(convs[1:], routes[1:]):
        assert r == ("mma" if l.out_channels % 8 == 0 else "gemm"), l.name
    assert routes.count("mma") >= len(convs) - 2


# ---------------------------------------------------------------------------
# the route-mma plan
# ---------------------------------------------------------------------------

def _mma_cases():
    cases = []
    for net, layers in (("vgg16", vgg16_layers()),
                        ("alexnet", alexnet_layers())):
        for l in layers:
            if l.in_channels % 16 == 0:
                cases += [(net, l.name, n) for n in (1, 4, 8)]
    return cases


@pytest.mark.parametrize("net,name,n", _mma_cases(),
                         ids=[f"{a}-{b}-n{c}" for a, b, c in _mma_cases()])
def test_wgrad_mma_plan_invariants(net, name, n):
    """A route-mma plan: chunks a pure function of the shape (the same
    plan on every build), the height the mma time model picks from the
    least chunk up, the workspace within the cap, every tile whole
    (128-row tiles of whole m16 fragments, 64- or 128-column tiles of
    whole n8 fragments), blocks = tiles x chunks."""
    layers = vgg16_layers() if net == "vgg16" else alexnet_layers()
    l = next(x for x in layers if x.name == name)
    xs, ws, pads = _problem(l, n)
    kw = dict(stride=l.stride, pad=pads, groups=l.groups, dtype_bytes=2)
    plan = WeightGradPlan.build(xs, ws, **kw)
    assert plan.route == "mma"
    assert WeightGradPlan.build(xs, ws, **kw) == plan
    assert plan.workspace_bytes <= cp.WGRAD_WORKSPACE_CAP
    assert plan.chunks <= max(1, cp.WGRAD_WORKSPACE_CAP
                              // (4 * plan.dw_elems))
    assert plan.tile_cout == (64 if plan.cout_per_group <= 64 else 128)
    assert cp.WGRAD_MMA_TILE_ROWS % cp.BF16_MMA_M == 0
    assert plan.tile_cout % (cp.BF16_MMA_WARP_N) == 0
    assert plan.rows % cp.BF16_MMA_K == 0          # whole fragments a tap
    assert plan.cin_per_group % cp.BF16_MMA_K == 0
    assert plan.cout_per_group % cp.BF16_MMA_N == 0
    assert plan.tiles == (plan.groups
                          * -(-plan.rows // cp.WGRAD_MMA_TILE_ROWS)
                          * -(-plan.cout_per_group // plan.tile_cout))
    assert plan.blocks == plan.tiles * plan.chunks
    rows = plan.n * plan.h_out
    _, min_rows = cp._wgrad_min_rows(rows, plan.w_out, plan.dw_elems)
    best = min(range(rows, min_rows - 1, -1),
               key=lambda t: (plan.model_seconds(t), -t))
    assert plan.tile_go == best
    # the mma model runs at the bf16 rate on its own resident blocks
    flops, slots, peak = plan._model()
    assert (slots, peak) == (cp.WGRAD_MMA_SLOTS, cp.PEAK_BF16_FLOPS)
    assert flops == 2 * cp.WGRAD_MMA_TILE_ROWS * plan.tile_cout
    # a tuner override is raised to the cap and stays on the route
    low = WeightGradPlan.build(xs, ws, tile_go=1, **kw)
    assert low.route == "mma" and low.workspace_bytes <= \
        cp.WGRAD_WORKSPACE_CAP


def test_wgrad_mma_plan_of_vgg16_at_batch_8():
    """The route-mma plans of VGG-16 conv2-13 at N=8: conv2's chunk of
    35 cotangent rows (7840 positions, 490 k-steps, the order contract's
    example), conv9-13 one chunk (no workspace)."""
    plans = {}
    for l in vgg16_layers()[1:]:
        xs, ws, pads = _problem(l, 8)
        plans[l.name] = WeightGradPlan.build(xs, ws, pad=pads, dtype_bytes=2)
    c2 = plans["conv2"]
    assert (c2.tile_go, c2.chunks, c2.blocks) == (35, 52, 260)
    assert c2.tile_go * c2.w_out == 7840 == 490 * cp.BF16_MMA_K
    assert all(plans[f"conv{i}"].chunks == 1 for i in range(9, 14))
    assert all(plans[f"conv{i}"].workspace_bytes == 0 for i in range(9, 14))


@pytest.mark.parametrize("tile_cout", [64, 128])
def test_wgrad_mma_smem_and_conflict_free_pitches(tile_cout):
    """Route mma's stages: rows of 128 + 8 and tile_cout + 8 bf16, an odd
    count of 16-byte quads, so the eight rows of every ldmatrix phase
    (eight consecutive positions) fall in eight distinct bank quads; two
    blocks fit an SM."""
    pad = cp.WGRAD_MMA_PITCH_PAD
    for width in (cp.WGRAD_MMA_TILE_ROWS, tile_cout):
        quads = (width + pad) * 2 // 16
        assert (width + pad) * 2 % 16 == 0 and quads % 2 == 1
        for col in range(0, width, 8):
            banks = {((p * (width + pad) + col) * 2 // 16) % 8
                     for p in range(8)}
            assert len(banks) == 8
    smem = wgrad_mma_smem_bytes(tile_cout)
    assert smem == 3 * 64 * 2 * (128 + tile_cout + 16)
    assert smem <= cp.SMEM_PER_BLOCK
    assert cp.WGRAD_MMA_BLOCKS_PER_SM * (smem + cp.SMEM_RESERVED_PER_BLOCK) \
        <= cp.SMEM_PER_SM
    assert cp.WGRAD_MMA_POSITIONS % cp.BF16_MMA_K == 0


def test_wgrad_constants_match_the_kernel():
    """``trim_conv2d_wgrad.cu``'s constants and its route enum against
    their mirrors in ``core/conv_plan.py``; the mma route's A loader is
    the header's transposed x4 (a new constant needs a mirror here)."""
    header = _constexprs(CSRC / "bf16_mma.cuh")
    k = _constexprs(CSRC / "trim_conv2d_wgrad.cu", header)
    assert k == {
        "kThreads": cp.WGRAD_THREADS,
        "kTileRows": cp.WGRAD_TILE_ROWS,
        "kPositions": 16,
        "kStages": 3,
        "kMmaTileRows": cp.WGRAD_MMA_TILE_ROWS,
        "kMmaPositions": cp.WGRAD_MMA_POSITIONS,
        "kMmaStages": cp.WGRAD_MMA_STAGES,
        "kMmaBlocksPerSm": cp.WGRAD_MMA_BLOCKS_PER_SM,
        "kMmaXPitch": cp.WGRAD_MMA_TILE_ROWS + cp.WGRAD_MMA_PITCH_PAD,
    }
    assert header["kBf16RowPad"] == cp.WGRAD_MMA_PITCH_PAD
    text = (CSRC / "trim_conv2d_wgrad.cu").read_text()
    assert "enum WgradRoute { kRouteGemm = 0, kRouteDepthwise = 1, " \
        "kRouteMma = 2 };" in text
    assert cp.WGRAD_ROUTES == ("gemm", "depthwise", "mma")
    code = re.sub(r"//[^\n]*", "", text)
    assert '#include "bf16_mma.cuh"' in code
    assert "ldsm_x4_trans_a(" in code and "mma_bf16(" in code
    assert "mma.sync" not in code and "atomic" not in code
    assert "__launch_bounds__(kThreads, kMmaBlocksPerSm)" in code


# ---------------------------------------------------------------------------
# the flash kernel's bf16 narrow route
# ---------------------------------------------------------------------------

def test_flash_narrow_geometry_and_smem_match_the_kernel():
    """The narrow route's instances (Dp, warps, keys a tile) parsed from
    ``flash_attention.cu``'s launcher, its row padding and shared-memory
    limit; every instance fits 227 KB in f32 and bf16, and the bf16 rows
    (Dp + 8) are an odd count of 16-byte quads, so no ldmatrix phase of
    eight rows has a bank conflict."""
    text = (CSRC / "flash_attention.cu").read_text()
    found = {int(dp): (int(w), int(kk)) for dp, w, kk in re.findall(
        r"return launch<T, (\d+), (\d+), (\d+)>\(", text)}
    assert found == FLASH_NARROW
    assert "constexpr int kRowPad = 16 / (int)sizeof(T);" in text
    limit = int(re.search(r"constexpr int kMaxSmemBytes = (\d+);",
                          text).group(1))
    assert limit == cp.SMEM_PER_BLOCK
    smem = {(dp, eb): flash_narrow_smem_bytes(dp, eb)
            for dp in FLASH_NARROW for eb in (4, 2)}
    assert {dp: smem[dp, 2] for dp in FLASH_NARROW} == \
        {64: 55296, 128: 104448, 256: 101376}
    assert {dp: smem[dp, 4] for dp in FLASH_NARROW} == \
        {64: 104448, 128: 202752, 256: 199680}
    assert max(smem.values()) <= limit
    for dp in FLASH_NARROW:
        pitch = (dp + 8) * 2
        assert pitch % 16 == 0 and (pitch // 16) % 2 == 1
        for col in range(0, dp, 8):
            assert len({((r * (dp + 8) + col) * 2 // 16) % 8
                        for r in range(8)}) == 8
        warps, keys = FLASH_NARROW[dp]
        # whole k16 steps over d and over a tile's keys, whole n8 tiles
        assert dp % 32 == 0 and keys % 16 == 0 and dp % 16 == 0
        assert warps * 32 <= 256


def test_flash_bf16_route_runs_on_the_bf16_tensor_cores():
    """The bf16 branch of the narrow kernel calls the header's bf16 mma
    and ldmatrix loaders; the f32 branch keeps 3xTF32 (its SASS is held
    on the card)."""
    code = re.sub(r"//[^\n]*", "",
                  (CSRC / "flash_attention.cu").read_text())
    assert '#include "bf16_mma.cuh"' in code
    assert code.count("mma_bf16(") == 4           # S: 2, P V: 2
    assert "ldsm_x4_trans(" in code and "ldsm_x4(" in code
    assert code.count("mma_3xtf32(") == 2         # the f32 route's two
    assert "tf32_bits" not in code and "mma.sync" not in code


@pytest.mark.parametrize("d", [16, 128, 256])
def test_flash_bf16_p_split_error_budget(d):
    """P V with P split as the kernel splits it, p_hi = bf16_rn(p) and
    p_lo = bf16_rn(p - p_hi), against the exact bf16 V, on random softmax
    rows: p - p_hi is exact in f32 and p_hi + p_lo lies within 2^-16 of
    p (bf16's unit roundoff 2^-8, twice), so the product is within 2^-16
    of sum |p v| of the f32 P's; one bf16 P is off by up to 2^-8 of it,
    and here by more than 2^-12."""
    rng = np.random.default_rng(d)
    s = rng.standard_normal((64, 512)) * 4
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
    v = torch.from_numpy(rng.standard_normal((512, d)).astype(np.float32)
                         ).bfloat16().double()
    pt = torch.from_numpy(p)
    hi = pt.bfloat16().float()
    lo = (pt - hi).bfloat16().float()
    assert torch.equal((pt - hi).double(), pt.double() - hi.double())
    rest = (pt.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -16 * pt.double()).all()
    want = pt.double() @ v
    mass = pt.double() @ v.abs()
    split = hi.double() @ v + lo.double() @ v
    one = hi.double() @ v
    assert ((split - want).abs() <= 2.0 ** -16 * mass).all()
    assert ((one - want).abs() <= 2.0 ** -8 * mass).all()
    assert ((one - want).abs() / mass).max() > 2.0 ** -12
    assert ((split - want).abs() / mass).max() < 2.0 ** -17


# the narrow route's cases of tests/test_torch_cuda.py's FLASH_BF16_CASES:
# (b, lq, lk, hq, hkv, d, causal, soft_cap, window)
FLASH_NARROW_CASES = [
    (2, 40, 40, 4, 2, 16, True, None, None),
    (1, 33, 100, 7, 1, 14, False, None, 20),
    (1, 300, 300, 16, 2, 128, True, None, None),
    (2, 17, 1000, 16, 2, 128, True, None, None),
    (1, 150, 150, 10, 1, 256, True, 30.0, 70),
]
# chip_smoke.py's and tests/test_torch_cuda.py's FLASH_BF16_F64_EXCESS
FLASH_BF16_F64_EXCESS = 2.0 ** -14


def _flash_f64_excess(out, q, k, v, kw) -> float:
    """chip_smoke.flash_bf16_f64_excess: |out - o64| past the half ulp of
    bf16 at out, of max|o64|, o64 the plain version in float64."""
    from repro_torch.kernels import flash_attention as fa
    want = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                    **kw)
    of = out.float()
    half = torch.where(of == 0, torch.zeros_like(of),
                       torch.ldexp(torch.ones_like(of),
                                   torch.frexp(of)[1] - 9))
    return (((of.double() - want).abs() - half.double()).max().item()
            / want.abs().max().item())


def _flash_bf16_emulated(q, k, v, *, causal, soft_cap, window, p_terms):
    """The narrow route's arithmetic in f32 on the CPU, one softmax over
    all keys: S exact, P = exp(S - max), l = sum P in f32, o = (P V) / l
    rounded once to bf16, with P V taken as the kernel takes it (p_terms
    2: p_hi V + p_lo V) or as one bf16 P would (p_terms 1: p_hi V)."""
    from repro_torch.kernels import flash_attention as fa
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, lq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / d ** 0.5
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    mask = fa._mask(torch.arange(lq) + lk - lq, 0, lk, causal, window)
    assert mask.any(dim=1).all()
    s = torch.where(mask, s, fa.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    o = torch.einsum("bhgqk,bkhd->bhgqd", hi, v.float())
    if p_terms == 2:
        o = o + torch.einsum("bhgqk,bkhd->bhgqd", lo, v.float())
    o = o / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d).bfloat16()


@pytest.mark.parametrize("case", FLASH_NARROW_CASES,
                         ids=[str(i) for i in range(len(FLASH_NARROW_CASES))])
def test_flash_bf16_f64_gate_passes_the_split_and_refuses_one_bf16_p(case):
    """The card's gate on the narrow route (|o - o64| past half an ulp of
    bf16 within ``FLASH_BF16_F64_EXCESS`` of max|o64|) on the kernel's
    arithmetic emulated at the GPU test's narrow cases: the P split
    passes it by a wide margin, one bf16 P fails it by more than 4x, and
    the plain version itself (f32 P) passes.  The constant is the one
    ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the card to."""
    from repro_torch.kernels import flash_attention as fa
    root = Path(__file__).resolve().parents[1]
    for path in (root / "chip_smoke.py", root / "tests/test_torch_cuda.py"):
        assert re.search(r"^FLASH_BF16_F64_EXCESS = 2\.0 \*\* -14$",
                         path.read_text(), re.M), path
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator().manual_seed(lq + lk + d)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16()
               for shape in ((b, lq, hq, d), (b, lk, hkv, d),
                             (b, lk, hkv, d)))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    split = _flash_bf16_emulated(q, k, v, p_terms=2, **kw)
    one = _flash_bf16_emulated(q, k, v, p_terms=1, **kw)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    assert _flash_f64_excess(split, q, k, v, kw) <= \
        FLASH_BF16_F64_EXCESS / 16
    assert _flash_f64_excess(plain, q, k, v, kw) <= \
        FLASH_BF16_F64_EXCESS / 16
    assert _flash_f64_excess(one, q, k, v, kw) > 4 * FLASH_BF16_F64_EXCESS


@pytest.mark.parametrize("case", FLASH_NARROW_CASES[::2],
                         ids=["0", "2", "4"])
def test_flash_plain_forward_in_float64(case):
    """Given float64 q, k and v the plain forward computes in float64 (the
    card's oracle for the bf16 route): o and lse float64, within 1e-5 of
    max|o| of the f32 plain version on the same values, whose dtypes do
    not move."""
    from repro_torch.kernels import flash_attention as fa
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16()
               for shape in ((b, lq, hq, d), (b, lk, hkv, d),
                             (b, lk, hkv, d)))
    kw = dict(causal=causal, soft_cap=cap, window=win,
              block_k=fa.BLOCK_K)
    o64, lse64 = fa._plain_forward(q.double(), k.double(), v.double(), **kw)
    o32, lse32 = fa._plain_forward(q.float(), k.float(), v.float(), **kw)
    ob, lseb = fa._plain_forward(q, k, v, **kw)
    assert o64.dtype == lse64.dtype == torch.float64
    assert o32.dtype == lse32.dtype == lseb.dtype == torch.float32
    assert ob.dtype == torch.bfloat16
    assert torch.equal(ob, o32.bfloat16()) and torch.equal(lseb, lse32)
    assert (o64 - o32.double()).abs().max() <= 1e-5 * o64.abs().max()
    assert (lse64 - lse32.double()).abs().max() <= 1e-5 * lse64.abs().max()


# tests/test_torch_cuda.py's FLASH_BWD_CASES: (b, lq, lk, hq, hkv, d, causal,
# soft_cap, window)
FLASH_BWD_CASES = [
    (2, 100, 100, 4, 2, 16, True, None, None),
    (1, 130, 130, 7, 1, 64, True, None, None),
    (2, 45, 300, 8, 2, 128, True, None, None),
    (1, 200, 200, 10, 1, 256, True, 30.0, 70),
    (1, 70, 150, 6, 3, 12, False, 5.0, 40),
    (2, 520, 520, 16, 2, 64, True, None, None),
    (1, 90, 90, 3, 3, 32, False, None, 50),
]


def _chip_smoke():
    """``chip_smoke.py`` as a module (its emulation and gate)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=[str(i) for i in range(len(FLASH_BWD_CASES))])
def test_flash_bwd_bf16_f64_gate_passes_the_splits_and_refuses_one_bf16_p_or_ds(
        case):
    """The card's gate on the bf16 backward (dq, dk, dv past half an ulp
    of bf16 from the float64 plain backward within
    ``FLASH_BWD_BF16_F64_EXCESS`` of max|grad|) on the kernels' arithmetic
    emulated at the GPU test's cases: the P and dS splits pass it
    by 16x, as does the plain backward (f32) rounded once; one bf16 P
    fails it at dv and one bf16 dS at dk and dq, each by more than 4x.
    The constant and cases are the ones ``tests/test_torch_cuda.py``
    holds the card to."""
    from repro_torch.kernels import flash_attention as fa
    smoke = _chip_smoke()
    cuda_tests = (Path(__file__).resolve().parent / "test_torch_cuda.py"
                  ).read_text()
    assert "\n".join(f"    {c}," for c in FLASH_BWD_CASES) in cuda_tests
    gate = smoke.FLASH_BWD_BF16_F64_EXCESS
    assert re.search(r"^FLASH_BWD_BF16_F64_EXCESS = 2\.0 \*\* -14$",
                     cuda_tests, re.M)
    assert gate == 2.0 ** -14
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator().manual_seed(lq + lk + d)
    q, k, v, do = (torch.randn(shape, generator=gen).bfloat16()
                   for shape in ((b, lq, hq, d), (b, lk, hkv, d),
                                 (b, lk, hkv, d), (b, lq, hq, d)))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    _, lse64 = fa._plain_forward(q.double(), k.double(), v.double(),
                                 block_k=fa.BLOCK_K, **kw)
    want = fa.flash_attention_backward_plain(
        q.double(), k.double(), v.double(), lse64, do.double(), **kw)
    _, lse = fa._plain_forward(q, k, v, block_k=fa.BLOCK_K, **kw)

    def excess(grads):
        return [smoke.half_ulp_excess(torch, g, w)
                for g, w in zip(grads, want)]
    split = excess(smoke.flash_bwd_bf16_emulated(torch, q, k, v, do, kw))
    plain = excess(fa.flash_attention_backward_plain(q, k, v, lse, do, **kw))
    one_p = excess(smoke.flash_bwd_bf16_emulated(torch, q, k, v, do, kw,
                                                 p_terms=1))
    one_ds = excess(smoke.flash_bwd_bf16_emulated(torch, q, k, v, do, kw,
                                                  ds_terms=1))
    assert max(split) <= gate / 16 and max(plain) <= gate / 16, (split,
                                                                 plain)
    assert one_p[2] > 4 * gate and min(one_ds[:2]) > 4 * gate, (one_p,
                                                                 one_ds)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def test_wgrad_bf16_records_name_their_route_and_old_ones_stay_off_mma():
    """A bf16 ``conv2d_wgrad:`` record names its route; one without
    (PR 31's FFMA design) is a miss, with a warning, on a layer of route
    mma, and read on a gemm or depthwise layer; an f32 record has no
    route field, as before."""
    mma = ((2, 12, 12, 16), (3, 3, 16, 32))
    gemm = ((2, 12, 12, 8), (3, 3, 8, 32))
    dw = ((2, 12, 12, 16), (3, 3, 1, 16))
    kw = dict(pad=1, dtype="bfloat16", device="cpu")
    rec = autotune.tune_weight_grad(*mma, **kw)
    assert rec["route"] == "mma"
    assert rec["tile_go"] == WeightGradPlan.build(
        *mma, pad=1, dtype_bytes=2).tile_go
    assert autotune.weight_grad_knobs_for(*mma, **kw)["route"] == "mma"
    assert autotune.tune_weight_grad(*gemm, **kw)["route"] == "gemm"
    assert autotune.tune_weight_grad(*dw, groups=16, **kw)["route"] == \
        "depthwise"
    assert "route" not in autotune.tune_weight_grad(*mma, pad=1,
                                                    device="cpu")
    for shapes, groups, kept in ((mma, 1, False), (gemm, 1, True),
                                 (dw, 16, True)):
        key = autotune.make_key(*shapes, pad=1, groups=groups,
                                dtype="bfloat16", device="cpu",
                                op="conv2d_wgrad")
        autotune.store(key, dict(tile_go=2))
        autotune.reset_memory_cache()
        if kept:
            assert autotune.weight_grad_knobs_for(
                *shapes, groups=groups, **kw)["tile_go"] == 2
        else:
            with pytest.warns(RuntimeWarning, match="wgrad route None"):
                assert autotune.weight_grad_knobs_for(
                    *shapes, groups=groups, **kw) is None
    # a record naming another route than the layer's is refused too
    key = autotune.make_key(*gemm, pad=1, dtype="bfloat16", device="cpu",
                            op="conv2d_wgrad")
    autotune.store(key, dict(tile_go=2, route="mma"))
    autotune.reset_memory_cache()
    with pytest.warns(RuntimeWarning, match="route 'mma' for a layer on "
                                            "route 'gemm'"):
        assert autotune.weight_grad_knobs_for(*gemm, **kw) is None
