"""The port's CUDA conv kernels on the card, against their plain versions.

Marked ``gpu``: every test skips (inside a fixture) where PyTorch sees no
GPU.  On a GPU host, from the repository root (the repo's conftest needs
JAX, which such a host need not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_cuda.py

Small random geometries that reach every edge of the kernel: ragged
bottom and right edges, bands narrower than the output, strides above K,
grouped and depthwise convs, C_out tiles that do not divide C_out, each
activation, carry segments of several strips with the prefetching ring,
tile_cout 3, Cin 3, and operands at a 4-byte offset.  Tolerance: 1e-4 * max(1, max|plain|) (f32 sums in
another order); carry and halo must agree bitwise.  The weight-gradient
kernel is held against its plain version within 1e-4 * max|plain| and
must repeat bitwise (its bf16 entry's f32 sums bitwise the f32 entry's
on the widened operands on routes gemm / depthwise, within a float64
bound on route mma, its bf16 dw those sums rounded once; one bf16
example-CNN train step on the kernels against the same step on the plain
versions: dw within one bf16 ulp, every other leaf bitwise); the input
gradient (the forward kernel on the dilated cotangent) and the autograd
conv against the ``ref`` oracle.  The
fused-group kernel is held against its plain version at the same
tolerance, must repeat bitwise, and must equal the per-layer carry chain
bitwise, forward and (through ``fused_group_apply``) backward, also at a
tile of exactly 227 KB, with a ragged last pass, cout % 4 != 0 and
cin = 3.  The
flash-attention kernel is held against its plain version and the ``ref``
oracle within 1e-5 * max|plain| (f32 sums in another order) on the CPU
tests' geometries plus head dims 12, 14, 128 and 256 and the wide-head
route's 320, 512 and 600, GQA groups 7 and 10,
windows, soft caps and ragged Lq / Lk; a SMOKE LM prefill on it against
``attn_impl="ref"``.  The flash backward kernels (dK/dV and dQ) are held
against their plain backward on the same lse and against autograd
of the ``ref`` oracle within 1e-4 of max|grad| (FFMA chains against
einsums) at head dims 12, 16, 64, 128 and 256 (windowed and soft-capped),
GQA groups up to 10 and Lq < Lk, and must repeat bitwise; the forward's o
is bitwise the same with and without its lse output; a loss through
``ops.attention(impl="flash")`` differentiates through them; and one
train step of a depth-2 SMOKE LM on the kernels (remat) matches the same
step on ``attn_impl="ref"`` (``_hold_first_step``: the gradients
themselves leaf by leaf within 1e-4 of each leaf's max, the params after
the step split by ``tests/test_torch_train_lm.py``'s settled rule).  The
conv1d backward kernels (dx: the forward kernel on the reversed
cotangent; dw: the weight-gradient kernel) equal their plain versions
bit for bit on the forward's cases, and one SMOKE train step of
falcon-mamba-7b and of recurrentgemma-2b (flash) on the kernels matches
the same step on the CPU by the same rule.  The conv1d kernel is held against its plain
version and the ``ref`` oracle bit for bit (the same rounded products
summed in the same order) on ragged runs, L < K-1, narrow channel
counts, K = 2..8 and strided views like the Mamba mixer's, and K = 9, 12
and 16 (the runtime-K instance), and recurrentgemma-2b's prefill shape; a
falcon-mamba-7b SMOKE prefill on it launches it once a layer and matches
the same prefill on the CPU within 1e-5 * max|logits| (GEMMs in another
order); recurrentgemma-2b cut to three layers (published widths, a
1024-token vocab, a 64-slot window) prefills on both kernels and matches
token-by-token decode across the ring wrap within 1e-4 * max|logits|.  The int8 conv kernel
is held against its plain version bit for bit (TOL for gelu / silu), carry
against halo bitwise, and a calibrated layer on the card against the CPU
bit for bit.  Rectangular (KH x KW) kernels, the sub-kernels of the
kernel tiling, are held like the square ones (carry, halo, wgrad), and
K > 8 through ``ops.conv2d`` (forward and gradients) against the ``ref``
oracle.  The geometries of the DAG topologies are held the same way at
full width: ResNet-18's 7x7/2 'same' stem at Cin 3 (pads 2 / 3), its
1x1/2 'valid' down-projection (no carried rows) and U-Net's 1x1 head,
with their weight and input gradients; ResNet-18 layer1's no-pool pair
and U-Net's three-stage group ending in the 1x1 head, as the plans tile
them, against their per-layer chains bitwise; and both tiny graphs
through ``cnn_apply_from_graph`` (halo and fused equal to carry
bitwise, carry against ``impl="ref"``).  The encoder-decoder family
(seamless-m4t-large-v2's calls: MHA at D 64, non-causal with Lq < Lk and
Lq > Lk, forward, backward and bf16, in the flash cases above) and its
full-width 2 + 2-layer cut: prefill and one train step on the card's
kernels, each held against the port's float64 oracle on the CPU
(``repro_torch.testing.float64``) within twice the CPU plain version's
distance from it (two f32 paths part by ~1e-2 there).  The MoE family
(qwen3-moe-30b-a3b's SMOKE widened to 32 experts, top 4): one layer on
the card against the CPU with the same experts, rows and counts (prefill
groups and decode's one group), its gradient bitwise on repeat, and a
train step bitwise on repeat.
"""

import math

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.kernels.ref import conv_pads

pytestmark = pytest.mark.gpu

TOL = 1e-4


def _bwd_counts(module, **nonzero) -> dict:
    """Every key of a wrapper module's ``BWD_LAUNCHES`` (f32 and bf16
    routes), 0 unless given."""
    return {**dict.fromkeys(module.BWD_LAUNCHES, 0), **nonzero}


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (n, h, w, cin, cout, k, stride, groups, padding, activation, tile_h,
#  tile_cout)
CASES = [
    (2, 9, 11, 4, 6, 3, 1, 1, "same", "relu", None, None),
    (2, 10, 10, 4, 8, 3, 2, 1, "same", None, None, None),
    (1, 11, 12, 6, 6, 5, 2, 3, "valid", "gelu", 2, 2),
    (3, 7, 8, 4, 4, 1, 2, 1, "valid", "silu", None, None),
    (2, 13, 13, 3, 5, 3, 1, 1, "same", "relu", 2, None),
    (2, 12, 12, 4, 4, 3, 1, 4, "same", "gelu", 3, None),
    (1, 40, 37, 8, 70, 3, 1, 1, "same", "relu", None, None),
    (1, 9, 9, 2, 40, 4, 3, 1, "valid", None, 3, 40),
    (2, 20, 33, 64, 96, 3, 1, 1, "same", "relu", 4, 96),
    (1, 17, 17, 16, 16, 7, 1, 16, "same", "silu", None, None),
    (1, 30, 30, 512, 64, 3, 1, 1, "same", "relu", None, None),
    (2, 28, 28, 32, 64, 3, 2, 2, "same", "relu", None, 32),
    (1, 15, 15, 40, 24, 3, 1, 1, "same", "relu", None, None),
    (2, 10, 10, 68, 20, 3, 2, 1, "same", "gelu", None, None),
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_kernels_match_plain(cuda, case):
    n, h, w, cin, cout, k, s, g, padding, act, tile_h, tile_cout = case
    gen = torch.Generator(device="cuda").manual_seed(len(CASES))
    x = torch.randn((n, h, w, cin), generator=gen, device=cuda)
    wt = torch.randn((k, k, cin // g, cout), generator=gen, device=cuda)
    b = torch.randn((cout,), generator=gen, device=cuda)
    pads = conv_pads(h, w, k, s, padding)
    kw = dict(stride=s, pad=pads, groups=g, activation=act)
    plain = tc.trim_conv2d_plain(x, wt, b, **kw)
    out = {}
    for df in ("carry", "halo"):
        before = tc.LAUNCHES[df]
        out[df] = tc.trim_conv2d(x, wt, b, dataflow=df, tile_h=tile_h,
                                 tile_cout=tile_cout, **kw)
        assert tc.LAUNCHES[df] == before + 1
    torch.cuda.synchronize()
    tol = TOL * max(1.0, plain.abs().max().item())
    for df, y in out.items():
        assert y.shape == plain.shape
        assert (y - plain).abs().max().item() <= tol, df
    assert torch.equal(out["carry"], out["halo"])


# The micro-tile's edges: carry segments of several strips with the
# prefetching window ring, tile_cout 3 (a thread's float4 of weights
# partly padding), Cin 3 and depthwise (4-byte window copies), stride 2,
# and operands at a 4-byte offset (4-byte copies instead of 16-byte).
# (n, h, w, cin, cout, k, stride, groups, tile_h, tile_cout, offset)
EDGE_CASES = [
    (8, 96, 96, 32, 64, 3, 1, 1, 2, None, False),
    (8, 50, 50, 12, 64, 3, 1, 1, 2, 3, False),
    (4, 33, 35, 3, 128, 3, 2, 1, None, None, False),
    (8, 40, 40, 48, 48, 3, 1, 48, None, None, False),
    (2, 19, 23, 16, 24, 3, 2, 1, None, None, True),
]


@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=[str(i) for i in range(len(EDGE_CASES))])
def test_micro_tile_edges_match_plain(cuda, case):
    from repro_torch.core.conv_plan import ConvPlan
    n, h, w, cin, cout, k, s, g, tile_h, tile_cout, offset = case
    gen = torch.Generator(device="cuda").manual_seed(h + w)
    x = torch.randn((n * h * w * cin + offset,), generator=gen,
                    device=cuda)[offset:].view(n, h, w, cin)
    wt = torch.randn((k * k * (cin // g) * cout + offset,), generator=gen,
                     device=cuda)[offset:].view(k, k, cin // g, cout)
    b = torch.randn((cout,), generator=gen, device=cuda)
    kw = dict(stride=s, pad=conv_pads(h, w, k, s, "same"), groups=g,
              activation="relu")
    plan = ConvPlan.build(tuple(x.shape), tuple(wt.shape), tile_h=tile_h,
                          tile_cout=tile_cout, **{k_: kw[k_] for k_ in
                                                  ("stride", "pad",
                                                   "groups")})
    if case[0] == 8 and tile_h is not None:
        assert plan.strips_per_segment > 1 and plan.prefetch
    plain = tc.trim_conv2d_plain(x, wt, b, **kw)
    carry = tc.trim_conv2d(x, wt, b, tile_h=tile_h, tile_cout=tile_cout,
                           **kw)
    halo = tc.trim_conv2d(x, wt, b, tile_h=tile_h, tile_cout=tile_cout,
                          dataflow="halo", **kw)
    torch.cuda.synchronize()
    tol = TOL * max(1.0, plain.abs().max().item())
    assert (carry - plain).abs().max().item() <= tol
    assert torch.equal(carry, halo)


def test_kernel_without_bias_and_batch_invariance(cuda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((4, 14, 14, 32), generator=gen, device=cuda)
    wt = torch.randn((3, 3, 32, 48), generator=gen, device=cuda)
    full = tc.trim_conv2d(x, wt, pad=1)
    for i in range(4):
        one = tc.trim_conv2d(x[i:i + 1].contiguous(), wt, pad=1)
        assert torch.equal(one[0], full[i])
    plain = tc.trim_conv2d_plain(x, wt, pad=1)
    assert (full - plain).abs().max().item() <= \
        TOL * max(1.0, plain.abs().max().item())


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    x = torch.randn((1, 8, 8, 4), device=cuda)
    w = torch.randn((3, 3, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        tc.trim_conv2d(x.half(), w.half())
    with pytest.raises(ValueError):
        tc.trim_conv2d(x.permute(0, 2, 1, 3), w)
    with pytest.raises(ValueError):
        tc.trim_conv2d(x, w.cpu())
    with pytest.raises(ValueError):      # window beyond shared memory
        tc.trim_conv2d(torch.randn((1, 8, 8, 8192), device=cuda),
                       torch.randn((3, 3, 8192, 4), device=cuda))


# (n, h, w, cin, cout, k, stride, groups, padding, tile_go): ragged last
# chunks and stages, chunks that cross image boundaries, row tiles that
# span taps (Cin/g < 128) or not, C_out tiles of 64 and 128 that do not
# divide C_out (70, 96, 130), a single chunk (dw written directly),
# grouped, the depthwise route, the 4-byte loaders (Cin/g = 2, 3;
# Cout/g = 6, 70, 130) and a plan of many chunks.
WGRAD_CASES = [
    (2, 9, 11, 4, 6, 3, 1, 1, "same", None),
    (2, 10, 10, 4, 8, 3, 2, 1, "same", 3),
    (1, 11, 12, 6, 6, 5, 2, 3, "valid", 1),
    (3, 7, 8, 4, 4, 1, 2, 1, "valid", None),
    (2, 13, 13, 3, 70, 3, 1, 1, "same", 5),
    (2, 12, 12, 4, 4, 3, 1, 4, "same", 2),
    (1, 20, 17, 64, 96, 3, 1, 1, "same", 7),
    (2, 16, 16, 128, 64, 3, 1, 1, "same", 1000),
    (2, 28, 28, 32, 64, 3, 2, 2, "same", None),
    (3, 15, 15, 40, 130, 3, 1, 1, "same", 4),
    (2, 20, 20, 16, 16, 7, 1, 16, "same", None),
    # VGG-16 conv2 at 1/2 the image: 50 chunks of 2,016 positions
    (8, 112, 112, 64, 64, 3, 1, 1, "same", None),
    # the smoke's depthwise case: the depthwise route, 896 chunks
    (8, 112, 112, 32, 32, 3, 1, 32, "same", None),
    # Cin/g 3 and Cout/g 6: both operands through the 4-byte loader
    (2, 20, 20, 6, 12, 3, 1, 2, "same", None),
]


def _wgrad_inputs(case, device):
    n, h, w, cin, cout, k, s, g, padding, tile_go = case
    gen = torch.Generator(device="cuda").manual_seed(len(WGRAD_CASES))
    x = torch.randn((n, h, w, cin), generator=gen, device=device)
    pads = conv_pads(h, w, k, s, padding)
    ho = (h + sum(pads[0]) - k) // s + 1
    wo = (w + sum(pads[1]) - k) // s + 1
    gy = torch.randn((n, ho, wo, cout), generator=gen, device=device)
    return x, gy, pads


@pytest.mark.parametrize("case", WGRAD_CASES,
                         ids=[str(i) for i in range(len(WGRAD_CASES))])
def test_wgrad_kernel_matches_plain_and_repeats_bitwise(cuda, case):
    n, h, w, cin, cout, k, s, g, padding, tile_go = case
    x, gy, pads = _wgrad_inputs(case, cuda)
    kw = dict(kernel_size=k, stride=s, pad=pads, groups=g)
    plain = tc.trim_conv2d_weight_grad_plain(x, gy, **kw)
    before = tc.LAUNCHES["wgrad"]
    one = tc.trim_conv2d_weight_grad(x, gy, tile_go=tile_go, **kw)
    two = tc.trim_conv2d_weight_grad(x, gy, tile_go=tile_go, **kw)
    torch.cuda.synchronize()
    assert tc.LAUNCHES["wgrad"] == before + 2
    assert one.shape == plain.shape == (k, k, cin // g, cout)
    assert (one - plain).abs().max().item() <= \
        TOL * plain.abs().max().item()
    assert torch.equal(one, two)


def test_wgrad_launcher_takes_and_checks_the_plan(cuda):
    """The plan's route, tile width and block count reach the launcher,
    which refuses a block count or route its own constants do not give;
    the card keeps as many GEMM blocks resident an SM as the plan's time
    model assumes."""
    import ctypes
    from repro_torch.core import conv_plan as cp
    from repro_torch.kernels import build
    lib = build.library("trim_conv2d_wgrad")
    for tile_cout in (cp.WGRAD_NARROW_TILE_COUT, cp.WGRAD_TILE_COUT):
        got = ctypes.c_int(0)
        assert lib.trim_conv2d_wgrad_resident_blocks(
            tile_cout, ctypes.byref(got)) == 0
        assert got.value == cp.WGRAD_BLOCKS_PER_SM, tile_cout
    x = torch.randn((2, 12, 12, 8), device=cuda)
    gy = torch.randn((2, 12, 12, 16), device=cuda)
    plan = cp.WeightGradPlan.build(tuple(x.shape), (3, 3, 8, 16), pad=1)
    dw = torch.empty(plan.dw_shape, device=cuda)
    ws = torch.empty((plan.chunks * plan.dw_elems,), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(depthwise, tile_cout, blocks):
        return lib.trim_conv2d_wgrad(
            x.data_ptr(), gy.data_ptr(), ws.data_ptr(), dw.data_ptr(),
            plan.n, plan.h, plan.w, plan.cin, plan.cout, plan.kh, plan.kw,
            plan.stride, 1, 1, plan.groups, plan.h_out, plan.w_out,
            plan.tile_go, depthwise, tile_cout, blocks, stream)

    assert plan.route == "gemm"
    assert launch(0, plan.tile_cout, plan.blocks) == 0
    torch.cuda.synchronize()
    assert launch(0, plan.tile_cout, plan.blocks + 1) != 0
    assert launch(0, 32, plan.blocks) != 0
    assert launch(1, plan.tile_cout, plan.blocks) != 0
    assert launch(2, plan.tile_cout, plan.blocks) != 0     # f32: no mma
    # route mma's instances: as many resident blocks as its plan assumes
    for tile_cout in (64, 128):
        got = ctypes.c_int(0)
        assert lib.trim_conv2d_wgrad_mma_resident_blocks(
            tile_cout, ctypes.byref(got)) == 0
        assert got.value == cp.WGRAD_MMA_BLOCKS_PER_SM, tile_cout


@pytest.mark.parametrize("case", WGRAD_CASES[:6],
                         ids=[str(i) for i in range(6)])
def test_input_grad_matches_ref(cuda, case):
    n, h, w, cin, cout, k, s, g, padding, _ = case
    x, gy, pads = _wgrad_inputs(case, cuda)
    wt = torch.randn((k, k, cin // g, cout), device=cuda)
    want = ref.conv2d_input_grad(x, wt, gy, stride=s, padding=padding,
                                 feature_group_count=g)
    for df in ("carry", "halo"):
        before = tc.LAUNCHES[df]
        got = tc.trim_conv2d_input_grad(gy, wt, x_shape=tuple(x.shape),
                                        stride=s, pad=pads, groups=g,
                                        dataflow=df)
        torch.cuda.synchronize()
        assert tc.LAUNCHES[df] == before + 1
        assert got.shape == x.shape
        assert (got - want).abs().max().item() <= \
            TOL * max(1.0, want.abs().max().item()), df


def test_autograd_conv_matches_ref_oracle(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, 12, 9, 8), generator=gen, device=cuda)
    wt = torch.randn((3, 3, 8, 16), generator=gen, device=cuda) * 0.3
    b = torch.randn((16,), generator=gen, device=cuda)

    def grads(impl):
        leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
        y = ops.conv2d(leaves[0], leaves[1], bias=leaves[2], stride=2,
                       activation="gelu", impl=impl)
        return torch.autograd.grad((y ** 2).sum(), leaves)

    for got, want in zip(grads("trim"), grads("ref")):
        assert (got - want).abs().max().item() <= \
            TOL * want.abs().max().item()


# Rectangular (KH x KW) kernels: the sub-kernels of the kernel tiling.
# AlexNet conv1's four shapes at stride 4 on 'valid' slices (no carried
# rows), carried rows at stride 1 and 2 with KH != KW both ways, the
# prefetching ring (several strips a segment), a depthwise 2 x 3, Cin 3
# with ragged C_out tiles, asymmetric pads, and a 4-byte operand offset.
# (n, h, w, cin, cout, kh, kw, stride, groups, pads, tile_h, offset)
RECT_CASES = [
    (2, 35, 35, 3, 96, 3, 3, 4, 1, 0, None, False),
    (2, 35, 34, 3, 96, 3, 2, 4, 1, 0, None, False),
    (2, 34, 35, 3, 96, 2, 3, 4, 1, 0, None, False),
    (2, 34, 34, 3, 96, 2, 2, 4, 1, 0, None, False),
    (8, 96, 95, 32, 64, 3, 2, 1, 1, 0, 2, False),
    (2, 21, 19, 12, 20, 2, 3, 2, 1, ((1, 0), (0, 1)), None, False),
    (2, 17, 19, 8, 8, 2, 3, 1, 8, ((0, 1), (1, 1)), None, False),
    (1, 15, 16, 3, 70, 3, 1, 1, 1, 0, None, True),
]


@pytest.mark.parametrize("case", RECT_CASES,
                         ids=[str(i) for i in range(len(RECT_CASES))])
def test_rectangular_kernels_match_plain(cuda, case):
    n, h, w, cin, cout, kh, kw, s, g, pads, tile_h, offset = case
    gen = torch.Generator(device="cuda").manual_seed(h * w + kh)
    x = torch.randn((n * h * w * cin + offset,), generator=gen,
                    device=cuda)[offset:].view(n, h, w, cin)
    wt = torch.randn((kh * kw * (cin // g) * cout + offset,), generator=gen,
                     device=cuda)[offset:].view(kh, kw, cin // g, cout)
    b = torch.randn((cout,), generator=gen, device=cuda)
    kw_ = dict(stride=s, pad=pads, groups=g, activation="relu")
    plain = tc.trim_conv2d_plain(x, wt, b, **kw_)
    before = dict(tc.LAUNCHES)
    carry = tc.trim_conv2d(x, wt, b, tile_h=tile_h, **kw_)
    halo = tc.trim_conv2d(x, wt, b, tile_h=tile_h, dataflow="halo", **kw_)
    torch.cuda.synchronize()
    assert tc.LAUNCHES["carry"] == before["carry"] + 1
    assert tc.LAUNCHES["halo"] == before["halo"] + 1
    assert carry.shape == plain.shape
    assert (carry - plain).abs().max().item() <= \
        TOL * max(1.0, plain.abs().max().item())
    assert torch.equal(carry, halo)


# (n, h, w, cin, cout, kh, kw, stride, groups, tile_go): AlexNet conv1's
# sub-kernel shapes on 'valid' slices, carried rows, the depthwise route
# and the 4-byte loaders (Cin/g 3, Cout/g 6).
RECT_WGRAD_CASES = [
    (2, 35, 35, 3, 96, 3, 3, 4, 1, None),
    (2, 35, 34, 3, 96, 3, 2, 4, 1, 3),
    (2, 34, 35, 3, 96, 2, 3, 4, 1, None),
    (2, 34, 34, 3, 96, 2, 2, 4, 1, 1),
    (2, 20, 18, 32, 64, 3, 2, 1, 1, 5),
    (2, 19, 21, 16, 16, 2, 3, 1, 16, None),
    (2, 13, 14, 6, 12, 3, 1, 2, 2, None),
]


@pytest.mark.parametrize("case", RECT_WGRAD_CASES,
                         ids=[str(i) for i in range(len(RECT_WGRAD_CASES))])
def test_rectangular_wgrad_matches_plain_and_repeats_bitwise(cuda, case):
    n, h, w, cin, cout, kh, kw, s, g, tile_go = case
    gen = torch.Generator(device="cuda").manual_seed(kh * 10 + kw)
    x = torch.randn((n, h, w, cin), generator=gen, device=cuda)
    gy = torch.randn((n, (h - kh) // s + 1, (w - kw) // s + 1, cout),
                     generator=gen, device=cuda)
    kw_ = dict(kernel_size=(kh, kw), stride=s, pad=0, groups=g)
    plain = tc.trim_conv2d_weight_grad_plain(x, gy, **kw_)
    one = tc.trim_conv2d_weight_grad(x, gy, tile_go=tile_go, **kw_)
    two = tc.trim_conv2d_weight_grad(x, gy, tile_go=tile_go, **kw_)
    torch.cuda.synchronize()
    assert one.shape == plain.shape == (kh, kw, cin // g, cout)
    assert (one - plain).abs().max().item() <= \
        TOL * plain.abs().max().item()
    assert torch.equal(one, two)


# K > 8 through ops.conv2d: AlexNet conv1's geometry ('valid', stride 4)
# and a 'same' K 9 depthwise conv, forward and gradients against the ref
# oracle; each forward launches the carry kernel once a sub-kernel.
LARGE_K_CASES = [((2, 39, 39, 3), (11, 11, 3, 32), 4, 1, "valid", "relu"),
                 ((2, 19, 17, 8), (9, 9, 1, 8), 1, 8, "same", "gelu")]


@pytest.mark.parametrize("case", LARGE_K_CASES, ids=["k11", "k9_dw"])
def test_large_k_op_and_gradients_match_ref(cuda, case):
    xs, ws, s, g, padding, act = case
    gen = torch.Generator(device="cuda").manual_seed(ws[0])
    x = torch.randn(xs, generator=gen, device=cuda)
    wt = torch.randn(ws, generator=gen, device=cuda) / ws[0]
    b = torch.randn((ws[3],), generator=gen, device=cuda)
    kw_ = dict(stride=s, padding=padding, feature_group_count=g, bias=b,
               activation=act)
    before = tc.LAUNCHES["carry"]
    y = ops.conv2d(x, wt, **kw_)
    torch.cuda.synchronize()
    assert tc.LAUNCHES["carry"] == before + ops.conv_launches(ws[0])
    want = ops.conv2d(x, wt, impl="ref", **kw_)
    assert (y - want).abs().max().item() <= \
        TOL * max(1.0, want.abs().max().item())

    def grads(impl):
        leaves = [t.clone().requires_grad_() for t in (x, wt, b)]
        out = ops.conv2d(leaves[0], leaves[1], stride=s, padding=padding,
                         feature_group_count=g, bias=leaves[2],
                         activation=act, impl=impl)
        return torch.autograd.grad((out ** 2).sum(), leaves)

    for got, want in zip(grads("trim"), grads("ref")):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= \
            TOL * want.abs().max().item()


# Edge groups of the fused kernel's schedule, as in
# tests/test_torch_fused.py: (layers, tile).  "limit": exactly 227 KB of
# shared memory, a ragged last pass and C_out tile, cout % 4 != 0;
# "cin3": cin = 3 (the scalar route) at VGG-16's conv1..conv2 widths.
FUSED_EDGES = {
    "limit": ([("e0", 20, 44, 60, 3, 1, 1), ("e1", 20, 60, 6, 3, 1, 1)],
              (19, 20)),
    "cin3": ([("v1", 32, 3, 64, 3, 1, 1), ("v2", 32, 64, 64, 3, 1, 1),
              ("v3", 16, 64, 32, 3, 1, 1)], (2, 3)),
}
# Fused groups: (layers as ConvLayer args, activation, biases, tiles).
# The CPU tests' chains (even pool, 'valid' strided stage with an
# overlapping 3/2 pool and a pointwise stage, pool-free), a wide chain
# whose C_out tiles and weight ring stages are ragged, a four-stage chain
# through two pools, and the edge groups at their tile and at 7 x 6.
FUSED_CASES = [
    ([("c0", 12, 3, 4, 3, 1, 1), ("c1", 12, 4, 6, 3, 1, 1),
      ("c2", 6, 6, 8, 3, 1, 1)], "relu", True, [(1, 1), (2, 3), (6, 6)]),
    ([("s0", 17, 3, 4, 5, 2, 0), ("s1", 3, 4, 8, 1, 1, 0),
      ("s2", 3, 8, 8, 3, 1, 1)], "gelu", True, [(1, 1), (2, 3), (3, 3)]),
    ([("p0", 9, 2, 4, 3, 1, 1), ("p1", 9, 4, 4, 3, 1, 1),
      ("p2", 9, 4, 6, 3, 1, 1)], "silu", False, [(1, 2), (4, 9), (9, 9)]),
    ([("a", 20, 3, 70, 3, 1, 1), ("b", 20, 70, 40, 3, 1, 1),
      ("c", 10, 40, 33, 3, 1, 1)], "relu", True, [(2, 3), (5, 10)]),
    ([("d0", 16, 8, 16, 3, 1, 1), ("d1", 8, 16, 32, 3, 1, 1),
      ("d2", 4, 32, 32, 3, 1, 1), ("d3", 4, 32, 64, 3, 1, 1)], None, True,
     [(1, 1), (2, 4)]),
] + [(spec, "relu", True, [tile, (7, 6)])
     for spec, tile in FUSED_EDGES.values()]


@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=[str(i) for i in range(len(FUSED_CASES))])
def test_fused_kernel_matches_plain_and_the_per_layer_chain(cuda, case):
    from repro_torch.core.fuse_plan import build_group
    from repro_torch.core.model import ConvLayer
    from repro_torch.kernels import trim_conv2d_fused as tfu
    spec, act, with_bias, tiles = case
    topo = [ConvLayer(*a) for a in spec]
    gen = torch.Generator(device="cuda").manual_seed(len(FUSED_CASES))
    x = torch.randn((2, topo[0].ifmap, topo[0].ifmap, topo[0].in_channels),
                    generator=gen, device=cuda)
    ws = [torch.randn((l.kernel, l.kernel, l.in_channels, l.out_channels),
                      generator=gen, device=cuda) / (l.kernel * l.in_channels
                                                     ** 0.5) for l in topo]
    bs = [torch.randn((l.out_channels,), generator=gen, device=cuda)
          if with_bias else None for l in topo]
    chain = None
    for t, b in tiles:
        g = build_group(topo, 0, n=2, strip_rows=t, band_cols=b)
        before = tc.LAUNCHES["fused"]
        one = tfu.trim_conv2d_fused(x, ws, bs, group=g, activation=act)
        two = tfu.trim_conv2d_fused(x, ws, bs, group=g, activation=act)
        torch.cuda.synchronize()
        assert tc.LAUNCHES["fused"] == before + 2
        plain = tfu.trim_conv2d_fused_plain(x, ws, bs, group=g,
                                            activation=act)
        if chain is None:
            chain = tfu.reference_chain(x, ws, bs, group=g, activation=act)
        assert one.shape == plain.shape == g.out_shape
        assert (one - plain).abs().max().item() <= \
            TOL * max(1.0, plain.abs().max().item()), (t, b)
        assert torch.equal(one, two), (t, b)
        assert torch.equal(one, chain), (t, b)


@pytest.mark.parametrize("name", sorted(FUSED_EDGES))
def test_fused_edge_gradients_equal_the_per_layer_chain(cuda, name):
    """The edge groups through ``fused_group_apply``: the forward equals
    the per-layer chain bitwise, and so does every gradient (the backward
    recomputes the chain)."""
    from repro_torch.core.fuse_plan import build_group
    from repro_torch.core.model import ConvLayer
    from repro_torch.kernels import trim_conv2d_fused as tfu
    spec, (t, b) = FUSED_EDGES[name]
    topo = [ConvLayer(*a) for a in spec]
    g = build_group(topo, 0, n=2, strip_rows=t, band_cols=b)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((2, topo[0].ifmap, topo[0].ifmap, topo[0].in_channels),
                    generator=gen, device=cuda)
    ws = [torch.randn((3, 3, l.in_channels, l.out_channels), generator=gen,
                      device=cuda) / (3 * l.in_channels ** 0.5) for l in topo]
    bs = [torch.randn((l.out_channels,), generator=gen, device=cuda)
          for l in topo]
    gy = torch.randn(g.out_shape, generator=gen, device=cuda)
    d = len(topo)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
        y = fn(leaves[0], leaves[1:1 + d], leaves[1 + d:], group=g)
        return y, torch.autograd.grad(y, leaves, gy)

    before = tc.LAUNCHES["fused"]
    yf, fused = grads(tfu.fused_group_apply)
    assert tc.LAUNCHES["fused"] == before + 1
    yc, chain = grads(tfu.reference_chain)
    assert torch.equal(yf, yc)
    for a, c in zip(fused, chain):
        assert torch.equal(a, c)


def test_fused_group_gradients_equal_the_per_layer_chain(cuda):
    from repro_torch.core.fuse_plan import build_group
    from repro_torch.core.model import ConvLayer
    from repro_torch.kernels import trim_conv2d_fused as tfu
    topo = [ConvLayer("c0", 12, 3, 8, 3, 1, 1),
            ConvLayer("c1", 12, 8, 16, 3, 1, 1),
            ConvLayer("c2", 6, 16, 8, 3, 1, 1)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = build_group(topo, 0, n=2, strip_rows=2, band_cols=3)
    x = torch.randn((2, 12, 12, 3), generator=gen, device=cuda)
    ws = [0.3 * torch.randn((3, 3, l.in_channels, l.out_channels),
                            generator=gen, device=cuda) for l in topo]
    bs = [torch.randn((l.out_channels,), generator=gen, device=cuda)
          for l in topo]
    gy = torch.randn(g.out_shape, generator=gen, device=cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
        y = fn(leaves[0], leaves[1:4], leaves[4:], group=g)
        return y, torch.autograd.grad(y, leaves, gy)

    yf, fused = grads(tfu.fused_group_apply)
    yc, chain = grads(tfu.reference_chain)
    assert torch.equal(yf, yc)
    for a, b in zip(fused, chain):
        assert torch.equal(a, b)


# b, lq, lk, hq, hkv, d, causal, soft_cap, window
FLASH_CASES = [
    (2, 32, 32, 4, 2, 16, True, None, None),
    (1, 64, 64, 8, 8, 32, True, 30.0, None),
    (2, 17, 47, 4, 1, 16, True, None, None),
    (2, 32, 32, 4, 2, 16, False, None, None),
    (1, 64, 64, 4, 2, 16, True, None, 16),
    (2, 1, 40, 8, 2, 32, True, None, None),
    (1, 150, 150, 10, 1, 256, True, 30.0, 70),
    (1, 17, 300, 16, 2, 128, True, None, None),
    (1, 33, 100, 7, 1, 14, False, None, 20),
    (1, 130, 130, 6, 2, 12, True, None, None),
    (2, 70, 200, 9, 3, 128, False, 5.0, None),
    (1, 300, 300, 16, 2, 128, True, None, None),
    # the narrow route's 3xTF32 tiles at Dp 64, 128 and 256: ragged Lq /
    # Lk, windows, soft caps, and long key ranges (thousands of truncating
    # tensor-core accumulations, the accuracy hazard of that route)
    (1, 77, 203, 8, 2, 64, True, 20.0, 50),
    (2, 45, 4100, 8, 2, 128, True, None, None),
    (1, 129, 257, 6, 3, 128, False, 30.0, 100),
    (1, 95, 1000, 4, 1, 256, True, 15.0, 300),
    (1, 33, 2100, 5, 5, 256, True, None, None),
    # D > 256: the wide-head route (D in chunks, 256 output columns a block)
    (1, 150, 150, 4, 2, 320, True, None, None),
    (2, 70, 130, 6, 2, 320, False, 30.0, 40),
    (1, 100, 100, 2, 1, 512, True, None, 33),
    (1, 17, 80, 3, 1, 600, True, None, None),
    # seamless-m4t-large-v2's calls: MHA at D 64, non-causal, a target
    # shorter and longer than the source (cross-attention)
    (2, 100, 300, 16, 16, 64, False, None, None),
    (2, 300, 100, 16, 16, 64, False, None, None),
]
FLASH_TOL = 1e-5


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(i) for i in range(len(FLASH_CASES))])
def test_flash_kernel_matches_plain_and_oracle(cuda, case):
    from repro_torch.kernels import flash_attention as fa
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator(device="cuda").manual_seed(lq + lk)
    q = torch.randn((b, lq, hq, d), generator=gen, device=cuda)
    k = torch.randn((b, lk, hkv, d), generator=gen, device=cuda)
    v = torch.randn((b, lk, hkv, d), generator=gen, device=cuda)
    kw = dict(causal=causal, soft_cap=cap, window=win)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 2
    plain = fa.flash_attention_plain(q, k, v, **kw)
    oracle = ref.attention(q, k, v, causal=causal, logits_soft_cap=cap,
                           window=win)
    scale = plain.abs().max().item()
    assert (out - plain).abs().max().item() <= FLASH_TOL * scale
    assert (out - oracle).abs().max().item() <= FLASH_TOL * scale
    assert torch.equal(out, again)


def test_flash_kernel_reads_strided_views(cuda):
    """q/k/v as non-contiguous views of one fused QKV projection."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(9)
    qkv = torch.randn((2, 40, 4 + 2 + 2, 16), generator=gen, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_flash_wrapper_raises_on_cuda(cuda):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 8, 4, 16), device=cuda)
    kv = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):      # causal rows with no key
        fa.flash_attention(torch.zeros((1, 9, 4, 16), device=cuda), kv, kv)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros((1, 8, 3, 16), device=cuda), kv, kv)


# (b, lq, lk, hq, hkv, d, causal, soft_cap, window): the backward kernels'
# three instances (Dp 64, 128, 256), GQA groups 1, 2, 4, 7, 8 and 10,
# ragged Lq < Lk, windows and soft caps, several row and key tiles; G 8
# over 9 key tiles (the heads' partials and their ordered sum), and G 1
# (dK and dV written directly, no sum)
FLASH_BWD_CASES = [
    (2, 100, 100, 4, 2, 16, True, None, None),
    (1, 130, 130, 7, 1, 64, True, None, None),
    (2, 45, 300, 8, 2, 128, True, None, None),
    (1, 200, 200, 10, 1, 256, True, 30.0, 70),
    (1, 70, 150, 6, 3, 12, False, 5.0, 40),
    (2, 520, 520, 16, 2, 64, True, None, None),
    (1, 90, 90, 3, 3, 32, False, None, 50),
    # seamless-m4t-large-v2's calls: MHA at D 64 (G 1), non-causal with
    # Lq < Lk and Lq > Lk (cross-attention), and causal (the decoder)
    (2, 100, 300, 16, 16, 64, False, None, None),
    (2, 300, 100, 16, 16, 64, False, None, None),
    (2, 200, 200, 16, 16, 64, True, None, None),
]
FLASH_BWD_TOL = 1e-4


@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=[str(i) for i in range(len(FLASH_BWD_CASES))])
def test_flash_backward_kernels_match_plain(cuda, case):
    """dq, dk, dv of the backward kernels against the plain backward on
    the same lse (1e-4 of max|grad|: 3xTF32 tiles against f32 einsums),
    against autograd of the ``ref`` oracle, and bitwise equal over two
    calls; o bitwise the same with and without lse; the partials' sum
    launched once a call where G > 1."""
    from repro_torch.kernels import flash_attention as fa
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator(device="cuda").manual_seed(lq + d)
    q, do = (torch.randn((b, lq, hq, d), generator=gen, device=cuda)
             for _ in range(2))
    k, v = (torch.randn((b, lk, hkv, d), generator=gen, device=cuda)
            for _ in range(2))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    lse = torch.empty((b, hq, lq), device=cuda)
    o = fa._launch_forward(q, k, v, causal, cap, win, lse)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    _, plain_lse = fa._plain_forward(q, k, v, block_k=fa.BLOCK_K, **kw)
    assert (lse - plain_lse).abs().max().item() <= 1e-5 * plain_lse.abs(
        ).max().item()
    fa.reset_launch_counts()
    got = fa.flash_attention_backward(q, k, v, lse, do, **kw)
    again = fa.flash_attention_backward(q, k, v, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == _bwd_counts(
        fa, flash_attention_bwd_dkdv=2, flash_attention_bwd_dq=2,
        flash_attention_bwd_sum=2 * (hq > hkv))
    plain = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.attention(
        qq, kk, vv, causal=causal, logits_soft_cap=cap, window=win),
        (qq, kk, vv), do)
    for g, g2, p, w in zip(got, again, plain, want):
        assert torch.equal(g, g2)
        scale = p.abs().max().item()
        assert (g - p).abs().max().item() <= FLASH_BWD_TOL * scale
        assert (g - w).abs().max().item() <= FLASH_BWD_TOL * scale


@pytest.mark.parametrize("case", FLASH_BWD_CASES,
                         ids=[str(i) for i in range(len(FLASH_BWD_CASES))])
def test_flash_backward_bf16_within_the_plain_distance_of_float64(cuda,
                                                                   case):
    """The bf16 route of the backward kernels (bf16 mma for S and dP; P
    and dS split hi / lo for dV, dK, dQ): dq, dk and dv bf16, each no
    farther from the float64 plain backward than the plain bf16 backward
    (f32 math on the widened values, rounded once) is, plus one bf16 ulp
    of max|grad|, and past half an ulp of bf16 within
    ``FLASH_BWD_BF16_F64_EXCESS`` of max|grad| of it (the splits keep P
    and dS f32; one bf16 P or dS does not); bitwise over two calls; only
    the bf16 kernels launch; under autograd a bf16 q, k, v gets bf16
    gradients from them."""
    import math
    from repro_torch.kernels import flash_attention as fa
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator(device="cuda").manual_seed(lq + d + 1)
    bf = torch.bfloat16
    q, do = (torch.randn((b, lq, hq, d), generator=gen, device=cuda).to(bf)
             for _ in range(2))
    k, v = (torch.randn((b, lk, hkv, d), generator=gen, device=cuda).to(bf)
            for _ in range(2))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    lse = torch.empty((b, hq, lq), device=cuda)
    o = fa._launch_forward(q, k, v, causal, cap, win, lse)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    fa.reset_launch_counts()
    got = fa.flash_attention_backward(q, k, v, lse, do, **kw)
    again = fa.flash_attention_backward(q, k, v, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == _bwd_counts(
        fa, flash_attention_bwd_dkdv_bf16=2, flash_attention_bwd_dq_bf16=2,
        flash_attention_bwd_sum_bf16=2 * (hq > hkv))
    plain = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
    want = fa.flash_attention_backward_plain(
        q.double(), k.double(), v.double(), lse.double(), do.double(), **kw)
    for g, g2, p, w in zip(got, again, plain, want):
        assert g.dtype == bf and torch.equal(g, g2)
        scale = w.abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        assert (g.double() - w).abs().max().item() <= (
            p.double() - w).abs().max().item() + ulp
        gf = g.float()
        half = torch.where(gf == 0, torch.zeros_like(gf),
                           torch.ldexp(torch.ones_like(gf),
                                       torch.frexp(gf)[1] - 9))
        assert ((gf.double() - w).abs() - half.double()).max().item() <= \
            FLASH_BWD_BF16_F64_EXCESS * scale
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launch_counts()
    grads = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                                do)
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bf16": 1}
    assert fa.BWD_LAUNCHES["flash_attention_bwd_dq_bf16"] == 1
    for g, g0 in zip(grads, got):
        assert torch.equal(g, g0)


def test_flash_autograd_on_the_card_matches_ref(cuda):
    """A loss through ``ops.attention(impl="flash")`` differentiates
    through the kernels (one forward, one launch of each backward kernel,
    the partials' sum included: G = 4)
    to autograd of ``impl="ref"``; D > 256 under grad raises."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((2, 64, 8, 64), generator=gen, device=cuda)
    k, v = (torch.randn((2, 64, 2, 64), generator=gen, device=cuda)
            for _ in range(2))
    grads = {}
    for impl in ("flash", "ref"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launch_counts()
        out = ops.attention(*leaves, impl=impl, window=40)
        grads[impl] = torch.autograd.grad((out * out).sum(), leaves)
        want = 1 if impl == "flash" else 0
        assert fa.LAUNCHES["flash_attention"] == want
        assert fa.BWD_LAUNCHES == _bwd_counts(fa, **dict.fromkeys(
            ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
             "flash_attention_bwd_sum"), want))
    for g, w in zip(grads["flash"], grads["ref"]):
        assert (g - w).abs().max().item() <= FLASH_BWD_TOL * w.abs().max(
            ).item()
    wide = torch.zeros((1, 8, 2, 264), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="Queue 2 C"):
        fa.flash_attention(wide, wide, wide)


STEP_GRAD_TOL = 1e-4      # a gradient's stated error, of its leaf's max
STEP_TOL = 1e-4           # params, mu and nu after a step, of the tree's max
SETTLED_TOL = 1e-5        # tests/test_torch_train_lm.py's TOL


def _grads(cfg, state, batch):
    """The loss's gradient at ``state``'s params, taken apart from the
    step through ``api.forward`` / ``api.loss_fn``."""
    from repro_torch.models import api
    from repro_torch.optim import adamw
    live = [t.detach().clone().requires_grad_()
            for t in adamw.tree_leaves(state["params"])]
    logits, aux = api.forward(adamw.tree_unflatten(state["params"], live),
                              batch, cfg)
    return torch.autograd.grad(api.loss_fn(logits, batch["labels"], aux),
                               live)


def _hold_first_step(got, want, p0, opt, grad_tol=STEP_GRAD_TOL):
    """One AdamW step from the params ``p0`` on two paths, each ``(state
    after the step, metrics, gradient taken apart at p0)``, ``want`` the
    reference.  The gradients leaf by leaf within ``grad_tol`` of the
    leaf's max|g_ref|; the loss within 1e-5, the grad norm within 1e-4;
    mu and nu within ``STEP_TOL`` of each tree's max.  The params split
    by ``tests/test_torch_train_lm.py``'s ``_settled`` rule on the ref
    step's (clipped) gradient g = mu / (1 - b1): a first step moves an
    element by ``lr g / (|g| + eps)``, so where |g| is near the
    gradient's error that move takes the sign of rounding.  Settled
    elements within ``STEP_TOL`` of the tree's max; an unsettled one must
    step in the ref step's direction wherever |g| is above its leaf's
    stated error (``grad_tol`` x max|g|), and every other element moves
    by at most one first step, ``lr (1 + wd |p0|)`` + an ulp."""
    from repro_torch.optim import adamw
    (s, m, g), (sr, mr, gr) = got, want
    for i, (a, b) in enumerate(zip(g, gr)):
        err = (a - b).abs().max().item()
        assert err <= grad_tol * b.abs().max().item(), (i, err)
    assert abs(m["loss"].item() - mr["loss"].item()) <= 1e-5 * abs(
        mr["loss"].item())
    assert abs(m["grad_norm"].item() - mr["grad_norm"].item()) <= \
        1e-4 * mr["grad_norm"].item()
    for tree in (("opt", "mu"), ("opt", "nu")):
        a = torch.cat([t.flatten() for t in adamw.tree_leaves(
            s[tree[0]][tree[1]])])
        b = torch.cat([t.flatten() for t in adamw.tree_leaves(
            sr[tree[0]][tree[1]])])
        assert (a - b).abs().max().item() <= STEP_TOL * b.abs().max().item()
    lr = mr["lr"].item()
    params = adamw.tree_leaves(s["params"])
    ref_params = adamw.tree_leaves(sr["params"])
    scale = max(t.abs().max().item() for t in ref_params)
    for i, (p, pr, q0, mu, mur) in enumerate(zip(
            params, ref_params, p0, adamw.tree_leaves(s["opt"]["mu"]),
            adamw.tree_leaves(sr["opt"]["mu"]))):
        gl = (mur / (1 - opt.b1)).abs()
        settled = gl > torch.sqrt(opt.eps * grad_tol * gl.max()
                                  / SETTLED_TOL)
        if settled.any():
            err = (p - pr)[settled].abs().max().item()
            assert err <= STEP_TOL * scale, (i, err)
        decay = opt.weight_decay * q0 if q0.dim() >= 2 else 0.0
        signed = ~settled & (gl > grad_tol * gl.max())
        for d, dr in ((mu, mur), (q0 - p - lr * decay,
                                  q0 - pr - lr * decay)):
            assert torch.equal(torch.sign(d[signed]),
                               torch.sign(dr[signed])), i
        rest = ~settled & ~signed
        ulp = torch.nextafter(q0.abs(), torch.full_like(q0, torch.inf)) \
            - q0.abs()
        bound = lr * (1 + opt.weight_decay * q0.abs()) + ulp
        assert bool(((p - q0).abs() <= bound)[rest].all()), i


def test_lm_train_step_on_the_kernels_matches_ref(cuda):
    """One train step of a depth-2, narrow-width dense LM (qwen2.5-3b
    SMOKE, remat on) on the flash kernels against the same step on
    ``attn_impl="ref"`` from the same state, held by ``_hold_first_step``
    (the gradients themselves leaf by leaf within 1e-4 of each leaf's
    max: the 3xTF32 forward and backward against cuBLAS); the flash step
    launches the forward twice a layer (remat) and each backward kernel
    once a layer."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import AdamWConfig, adamw
    cfg = registry.get("qwen2.5-3b").SMOKE.replace(remat=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(2, cfg.vocab, (4, 65), device=cuda, generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for impl in ("flash", "ref"):
        state = steps.init_train_state(
            cfg, opt, torch.Generator(device="cuda").manual_seed(1))
        p0 = [t.clone() for t in adamw.tree_leaves(state["params"])]
        icfg = cfg.replace(attn_impl=impl)
        g = _grads(icfg, state, batch)
        fa.reset_launch_counts()
        state, metrics = steps.make_train_step(icfg, opt)(state, batch)
        if impl == "flash":
            assert fa.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
            assert fa.BWD_LAUNCHES == _bwd_counts(fa, **dict.fromkeys(
                ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
                 "flash_attention_bwd_sum"), cfg.n_layers))
        out[impl] = (state, metrics, g)
    _hold_first_step(out["flash"], out["ref"], p0, opt)


def test_lm_prefill_on_the_kernel_matches_ref(cuda):
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    cfg = registry.get("qwen2.5-3b").SMOKE
    p = init_params(api.params(cfg), torch.Generator(device="cuda")
                    .manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 100), device=cuda,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    fa.reset_launch_counts()
    lf, tf = steps.make_prefill_step(cfg.replace(attn_impl="flash"))(
        p, {"tokens": toks})
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    lr, tr = steps.make_prefill_step(cfg)(p, {"tokens": toks})
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    tol = 1e-4 * lr.abs().max().item()
    assert (lf - lr).abs().max().item() <= tol
    # the same greedy token, unless ref's top two lie within the tolerance
    last = lr[:, -1]
    picked = last.gather(1, tf[:, None])[:, 0]
    assert bool(((tf == tr) | (last.amax(1) - picked <= 2 * tol)).all())


# (b, length, d, k, tile_l, strided)
CONV1D_CASES = [
    (2, 2048, 512, 4, None, True),
    (2, 1000, 256, 4, 64, False),
    (2, 2, 64, 4, None, False),
    (1, 100, 24, 4, None, False),
    (3, 7, 5, 2, None, False),
    (2, 33, 16, 3, 5, True),
    (3, 37, 70, 8, 1, False),
    (1, 1, 8192, 4, None, True),
    # K > 8: the runtime-K instance
    (2, 300, 96, 9, None, True),
    (2, 100, 40, 16, 7, False),
    (1, 5, 33, 12, None, False),
    # recurrentgemma-2b's prefill: the rec mixer's (B, L, lru_width)
    (2, 4096, 2560, 4, None, False),
    # 16-byte rows with a partial last channel warp (f32 and bf16)
    (2, 300, 2600, 4, None, True),
]
# the f32 forward also at a 4-byte offset (one channel a lane)
CONV1D_F32_CASES = CONV1D_CASES + [(2, 300, 64, 4, None, "offset"),
                                   (1, 50, 40, 9, 3, "offset")]


@pytest.mark.parametrize("case", CONV1D_F32_CASES,
                         ids=[str(i) for i in range(len(CONV1D_F32_CASES))])
def test_conv1d_kernel_equals_plain_bitwise(cuda, case):
    """The f32 route on the new geometry (a warp a block over one run and
    one channel warp, 4 channels a lane where rows are 16-byte aligned,
    else one): bitwise its plain version and the oracle, and over two
    calls."""
    from repro_torch.kernels import trim_conv1d as tc1
    b, length, d, k, tile_l, view = case
    gen = torch.Generator(device="cuda").manual_seed(length + d)
    width = 2 * d if view is True else d + 1 if view == "offset" else d
    xz = torch.randn((b, length, width), generator=gen, device=cuda)
    x = xz[..., 1:d + 1] if view == "offset" else xz[..., :d]
    w = torch.randn((k, d), generator=gen, device=cuda)
    assert tc1.f32_vec(x, w) == (4 if d % 4 == 0 and view != "offset"
                                 else 1)
    before = tc1.LAUNCHES["trim_conv1d"]
    out = tc1.trim_conv1d(x, w, tile_l=tile_l)
    again = tc1.trim_conv1d(x, w, tile_l=tile_l)
    torch.cuda.synchronize()
    assert tc1.LAUNCHES["trim_conv1d"] == before + 2
    assert torch.equal(out, tc1.trim_conv1d_plain(x, w, tile_l=tile_l))
    assert torch.equal(out, ref.depthwise_conv1d(x, w))
    assert torch.equal(out, again)


@pytest.mark.parametrize("case", CONV1D_CASES,
                         ids=[str(i) for i in range(len(CONV1D_CASES))])
def test_conv1d_backward_kernels_equal_plain_bitwise(cuda, case):
    """dx (the forward kernel on the reversed cotangent) and dw (the
    weight-gradient kernel's runs and ordered groups) bitwise equal to
    their plain versions and over two calls, on the forward's cases
    (strided x, ragged runs, L < K, K up to 16); through the Function, a
    loss's gradient reaches a strided x's base as the same dx, and w as
    dw on the plan's own runs (``tile_l`` moves dw's rounding: it cuts
    the runs)."""
    from repro_torch.kernels import trim_conv1d as tc1
    b, length, d, k, tile_l, strided = case
    gen = torch.Generator(device="cuda").manual_seed(length + d + 1)
    xz = torch.randn((b, length, 2 * d if strided else d), generator=gen,
                     device=cuda)
    x = xz[..., :d]
    w = torch.randn((k, d), generator=gen, device=cuda)
    dy = torch.randn((b, length, d), generator=gen, device=cuda)
    tc1.reset_launch_counts()
    dx = tc1.trim_conv1d_input_grad(dy, w, tile_l=tile_l)
    dw = tc1.trim_conv1d_weight_grad(x, dy, k, tile_l=tile_l)
    dx2 = tc1.trim_conv1d_input_grad(dy, w, tile_l=tile_l)
    dw2 = tc1.trim_conv1d_weight_grad(x, dy, k, tile_l=tile_l)
    torch.cuda.synchronize()
    assert tc1.BWD_LAUNCHES == _bwd_counts(tc1, trim_conv1d_dx=2,
                                           trim_conv1d_wgrad=2)
    assert torch.equal(dx, tc1.trim_conv1d_input_grad_plain(
        dy, w, tile_l=tile_l))
    assert torch.equal(dw, tc1.trim_conv1d_wgrad_plain(x, dy, k,
                                                       tile_l=tile_l))
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    xg, wg = xz.clone().requires_grad_(), w.clone().requires_grad_()
    gxz, gw = torch.autograd.grad(tc1.trim_conv1d(xg[..., :d], wg),
                                  (xg, wg), dy)
    assert torch.equal(gxz[..., :d], dx)
    assert torch.equal(gw, tc1.trim_conv1d_weight_grad(x, dy, k))
    assert not gxz[..., d:].any()


@pytest.mark.parametrize("case", CONV1D_CASES,
                         ids=[str(i) for i in range(len(CONV1D_CASES))])
def test_conv1d_bf16_backward_kernels_equal_plain_bitwise(cuda, case):
    """The bf16 routes of the conv1d backward: dx (``trim_conv1d_bf16``
    on the reversed cotangent) and dw (``trim_conv1d_wgrad_bf16``, the
    redesigned plan's runs and groups, 8 channels a lane where rows are
    16-byte aligned) bitwise their plain versions and over two calls; dw's
    f32 sums are the f32 entry's on the widened operands, rounded once;
    through the Function a bf16 x and w get bf16 gradients."""
    from repro_torch.kernels import trim_conv1d as tc1
    b, length, d, k, tile_l, strided = case
    gen = torch.Generator(device="cuda").manual_seed(length + d + 2)
    bf = torch.bfloat16
    xz = torch.randn((b, length, 2 * d if strided else d), generator=gen,
                     device=cuda).to(bf)
    x = xz[..., :d]
    w = torch.randn((k, d), generator=gen, device=cuda).to(bf)
    dy = torch.randn((b, length, d), generator=gen, device=cuda).to(bf)
    tc1.reset_launch_counts()
    dx = tc1.trim_conv1d_input_grad(dy, w, tile_l=tile_l)
    dw = tc1.trim_conv1d_weight_grad(x, dy, k, tile_l=tile_l)
    dx2 = tc1.trim_conv1d_input_grad(dy, w, tile_l=tile_l)
    dw2 = tc1.trim_conv1d_weight_grad(x, dy, k, tile_l=tile_l)
    torch.cuda.synchronize()
    assert tc1.BWD_LAUNCHES == _bwd_counts(tc1, trim_conv1d_dx_bf16=2,
                                           trim_conv1d_wgrad_bf16=2)
    assert dx.dtype == dw.dtype == bf
    assert torch.equal(dx, tc1.trim_conv1d_input_grad_plain(
        dy, w, tile_l=tile_l))
    plan = tc1._wgrad_plan(x, dy, k, tile_l)
    assert torch.equal(dw, tc1.trim_conv1d_wgrad_plain(x, dy, k,
                                                       tile_l=plan.tile_l))
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    if plan.vec == 8:    # the same plan in f32: 4 channels a lane
        wide = tc1.trim_conv1d_wgrad_plain(x.float(), dy.float(), k,
                                           tile_l=plan.tile_l)
        assert torch.equal(dw, wide.to(bf))
    xg, wg = xz.clone().requires_grad_(), w.clone().requires_grad_()
    gxz, gw = torch.autograd.grad(tc1.trim_conv1d(xg[..., :d], wg),
                                  (xg, wg), dy)
    assert gxz.dtype == gw.dtype == bf
    assert torch.equal(gxz[..., :d], dx)
    assert not gxz[..., d:].any()


@pytest.mark.parametrize("case", [
    (1, 4096, 2560, torch.bfloat16, "dx"),   # recurrentgemma-2b training
    (2, 2048, 8192, torch.float32, "fwd"),   # falcon-mamba-7b prefill
    (2, 300, 2600, torch.float32, "fwd"),    # a partial last channel warp
    (3, 37, 70, torch.bfloat16, "fwd")], ids=["c-bf16-dx", "a-f32",
                                              "d2600", "d70-vec1"])
def test_conv1d_launched_grid_has_no_idle_warp(cuda, case):
    """The grid the wrapper launched (``LAST_LAUNCH``): one warp a block,
    (runs x channel warps, B), and every block's warp owns channels of a
    run that holds steps, so no warp is launched idle; the kernel equals
    its plain version there."""
    from repro_torch.kernels import trim_conv1d as tc1
    b, length, d, dtype, part = case
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn((b, length, d), generator=gen, device=cuda).to(dtype)
    w = torch.randn((4, d), generator=gen, device=cuda).to(dtype)
    tc1.LAST_LAUNCH.clear()
    if part == "dx":
        out = tc1.trim_conv1d_input_grad(x, w)
        want = tc1.trim_conv1d_input_grad_plain(x, w)
    else:
        out = tc1.trim_conv1d(x, w)
        want = tc1.trim_conv1d_plain(x, w)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    got = dict(tc1.LAST_LAUNCH)
    plan = tc1.plan_for(x, w)
    assert got["grid"] == plan.grid and got["threads"] == 32
    assert (got["d"], got["length"]) == (d, length)
    d_warps = -(-d // got["tile_d"])
    runs = -(-length // got["tile_l"])
    assert got["grid"] == (runs * d_warps, b)
    assert got["tile_d"] == 32 * got["vec"]
    for block in range(got["grid"][0]):
        run, cw = divmod(block, d_warps)
        assert cw * got["tile_d"] < d and run * got["tile_l"] < length
    # D 2560 and 8192 are whole channel warps: no idle lane either
    if d % got["tile_d"] == 0:
        assert d_warps * got["tile_d"] == d


def _to_device(state, device):
    """A copy of a train state on ``device`` (the step updates in place)."""
    from repro_torch.optim import adamw
    return adamw.tree_unflatten(state, [t.to(device, copy=True)
                                        for t in adamw.tree_leaves(state)])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_ssm_and_hybrid_train_step_on_the_kernels_matches_the_cpu(cuda,
                                                                  arch):
    """One SMOKE train step (remat; recurrentgemma-2b on the flash
    kernels) on the card's kernels against the same step on the CPU's
    plain versions from the same state, held by ``_hold_first_step``;
    the gradients within 1e-4 of each leaf's max (2e-4 for the hybrid:
    at its SMOKE config each f32 path reads up to ~1e-4 from float64,
    ``tests/test_torch_train_ssm.py``); the card's step launches the
    conv1d forward twice a rec layer, dx and dw once, and for the hybrid
    the flash forward twice and each backward kernel once an att
    layer."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.optim import AdamWConfig, adamw
    cfg = registry.get(arch).SMOKE.replace(remat=True, attn_impl="flash")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    toks = torch.randint(2, cfg.vocab, (4, 65),
                         generator=torch.Generator().manual_seed(0))
    cpu = steps.init_train_state(cfg, opt, torch.Generator().manual_seed(1))
    p0 = [t.clone() for t in adamw.tree_leaves(cpu["params"])]
    out = {}
    for dev in ("cpu", cuda):
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        state = _to_device(cpu, dev)
        g = _grads(cfg, state, batch)
        fa.reset_launch_counts()
        tc1.reset_launch_counts()
        state, metrics = steps.make_train_step(cfg, opt)(state, batch)
        out[str(dev)] = [_to_device(state, "cpu"),
                         {k: v.cpu() for k, v in metrics.items()},
                         [t.cpu() for t in g]]
    rec = sum(cfg.pattern_at(i) == "rec" for i in range(cfg.n_layers)) \
        if cfg.family == "hybrid" else cfg.n_layers
    att = cfg.n_layers - rec
    assert tc1.LAUNCHES["trim_conv1d"] == 2 * rec
    assert tc1.BWD_LAUNCHES == _bwd_counts(tc1, trim_conv1d_dx=rec,
                                           trim_conv1d_wgrad=rec)
    assert fa.LAUNCHES["flash_attention"] == 2 * att
    assert fa.BWD_LAUNCHES == _bwd_counts(fa, **dict.fromkeys(
        ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
         "flash_attention_bwd_sum"), att))
    _hold_first_step(out[str(cuda)], out["cpu"], p0, opt,
                     2e-4 if cfg.family == "hybrid" else STEP_GRAD_TOL)


# seamless-m4t-large-v2 cut to 2 encoder + 2 decoder layers at full
# width (d_model 1024, 16 heads of 64, d_ff 8192, vocab 256206): the card's
# kernels and the CPU's plain versions, each against the port's float64
# oracle (``repro_torch.testing.float64``) on the CPU.  The JAX
# initialiser's scores reach |s| ~ 300 at this width, so two f32 paths
# part by far more than a rounding (card against CPU ~1.5e-2 of
# max|logits| at this cut); each is held to the oracle instead: the
# card's error at most F64_FACTOR x the CPU's, or the floor below
ENCDEC_F64_FACTOR = 2.0
ENCDEC_CUT_TOL = 1e-4       # prefill logits' floor, of max|logits|
ENCDEC_CUT_LOSS_TOL = 1e-4  # the step's loss against the CPU's, relative


def _encdec_cut():
    from repro_torch.configs import registry
    return registry.get("seamless-m4t-large-v2").CONFIG.replace(
        enc_layers=2, dec_layers=2, n_layers=4, remat=True)


def _encdec_batch(cfg, b, tgt, src, seed):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(2, cfg.vocab, (b, tgt + 1), generator=gen)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "src": torch.randn((b, src, cfg.d_model), generator=gen)}


def _rel(a, b) -> float:
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def test_encdec_cut_at_full_width_prefill_on_the_card(cuda):
    """The cut's prefill (96 target tokens over 160 frames and 160 over
    96: cross calls with Lq < Lk and Lq > Lk) on the card's flash kernel
    (6 launches a forward: 2 encoder, 2 decoder self, 2 cross): its
    logits no farther from the float64 oracle than ENCDEC_F64_FACTOR x
    the CPU plain version's distance (or ENCDEC_CUT_TOL), its greedy
    tokens the oracle's unless the oracle's top two lie within twice that
    limit."""
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.testing import float64
    cfg = _encdec_cut()
    p = init_params(api.params(cfg), torch.Generator().manual_seed(0))
    pc, p64 = _to_device(p, cuda), float64.widen(p)
    for tgt, src in ((96, 160), (160, 96)):
        batch = _encdec_batch(cfg, 2, tgt, src, tgt)
        del batch["labels"]
        with float64.float64(), torch.no_grad():
            l64, _ = api.forward(p64, {"tokens": batch["tokens"],
                                       "src": batch["src"].double()},
                                 cfg.replace(attn_impl="ref"))
        lc, _ = steps.make_prefill_step(cfg)(p, batch)
        fa.reset_launch_counts()
        lg, tg = steps.make_prefill_step(cfg)(
            pc, {k: v.to(cuda) for k, v in batch.items()})
        assert fa.LAUNCHES == {"flash_attention": 6,
                               "flash_attention_bf16": 0}
        lg, tg = lg.cpu(), tg.cpu()
        card, cpu = _rel(lg, l64), _rel(lc, l64)
        lim = max(ENCDEC_F64_FACTOR * cpu, ENCDEC_CUT_TOL)
        print(f"encdec cut prefill {tgt} over {src}: of max|f64 logits| "
              f"card {card:.2e}, CPU {cpu:.2e}, card vs CPU "
              f"{_rel(lg, lc):.2e}")
        assert card <= lim
        last = l64[:, -1]
        picked = last.gather(1, tg[:, None])[:, 0]
        tol = 2 * lim * l64.abs().max().item()
        assert bool(((tg == last.argmax(1)) | (last.amax(1) - picked <= tol))
                    .all())


def test_encdec_cut_at_full_width_train_step_on_the_card(cuda):
    """One AdamW step of the cut (remat, 2 x 64 tokens over 96 frames):
    the card's gradient (flash forward and backward kernels) leaf by leaf
    no farther from the float64 oracle's than ENCDEC_F64_FACTOR x the CPU
    plain version's worst leaf (or STEP_GRAD_TOL); the step's loss the
    CPU step's within ENCDEC_CUT_LOSS_TOL; the card's step launches the
    forward twice a call (remat) and dQ and dK/dV once (6 calls: MHA, no
    partial sum); every leaf of its state finite."""
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.testing import float64
    cfg = _encdec_cut()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    cpu = steps.init_train_state(cfg, opt, torch.Generator().manual_seed(1))
    batch = _encdec_batch(cfg, 2, 64, 96, 3)
    live = [t.double().requires_grad_()
            for t in adamw.tree_leaves(cpu["params"])]
    with float64.float64():
        logits, _ = api.forward(
            adamw.tree_unflatten(cpu["params"], live),
            {"tokens": batch["tokens"], "src": batch["src"].double()},
            cfg.replace(attn_impl="ref"))
        lp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(lp, -1, batch["labels"][..., None])[..., 0]
        g64 = torch.autograd.grad(loss.mean(), live)
    out = {}
    for dev in ("cpu", cuda):
        b = {k: v.to(dev) for k, v in batch.items()}
        state = _to_device(cpu, dev)
        g = _grads(cfg, state, b)
        fa.reset_launch_counts()
        state, metrics = steps.make_train_step(cfg, opt)(state, b)
        out[str(dev)] = (_to_device(state, "cpu"),
                         {k: v.cpu() for k, v in metrics.items()},
                         max(_rel(a.cpu(), w) for a, w in zip(g, g64)))
    assert fa.LAUNCHES == {"flash_attention": 12, "flash_attention_bf16": 0}
    assert fa.BWD_LAUNCHES == _bwd_counts(
        fa, flash_attention_bwd_dkdv=6, flash_attention_bwd_dq=6)
    (s, m, card), (_, mc, cpu_err) = out[str(cuda)], out["cpu"]
    print(f"encdec cut step: gradients of each leaf's max|f64|, card "
          f"{card:.2e}, CPU {cpu_err:.2e}; loss {m['loss'].item():.6f} vs "
          f"{mc['loss'].item():.6f}")
    assert card <= max(ENCDEC_F64_FACTOR * cpu_err, STEP_GRAD_TOL)
    assert abs(m["loss"].item() - mc["loss"].item()) <= \
        ENCDEC_CUT_LOSS_TOL * abs(mc["loss"].item())
    assert all(bool(torch.isfinite(t).all()) for t in adamw.tree_leaves(s))


# The MoE family at a widened SMOKE (32 experts, top 4): the experts run
# as einsums on either device; what the card must keep is the routing
# (a stable top-k, a stable dispatch sort) and a deterministic dispatch
# and combine (``layers._GatherRows``: no float atomics)
def _moe_cfg():
    from repro_torch.configs import registry
    return registry.get("qwen3-moe-30b-a3b").SMOKE.replace(
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=32, moe_dff=128,
        n_experts=32, top_k=4, attn_impl="flash", remat=True)


@pytest.mark.parametrize("s", [64, 1], ids=["prefill", "decode"])
def test_moe_apply_on_the_card_matches_the_cpu(cuda, s):
    """One MoE layer on the card against the CPU plain path on the same
    f32 inputs (prefill: a group a sequence; decode: one group of 8
    tokens, cap 2): the same experts, buffer rows and counts; y within
    TOL of max|y|; aux within 1e-6 of it."""
    from repro_torch.models import layers
    from repro_torch.models.base import init_params
    from repro_torch.testing import float64
    cfg = _moe_cfg()
    p = init_params(layers.moe_params(cfg), torch.Generator().manual_seed(0))
    b = 8 if s == 1 else 2
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    tg = b if s == 1 else s
    cap = max(math.ceil(tg * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor), 1)
    out = {}
    for dev in ("cpu", cuda):
        with float64.routes() as rec, torch.no_grad():
            y, aux = layers.moe_apply(_to_device(p, dev), x.to(dev), cfg)
        disp = layers.moe_dispatch(rec[0], cfg.n_experts, cap)
        out[str(dev)] = (y.cpu(), aux.cpu(), rec[0].cpu(),
                         [t.cpu() for t in disp])
    (y, aux, idx, disp), (yc, auxc, idxc, dispc) = out[str(cuda)], out["cpu"]
    assert torch.equal(idx, idxc)
    for a, w in zip(disp, dispc):
        assert torch.equal(a, w)
    assert _rel(y, yc) <= TOL
    assert abs(aux.item() - auxc.item()) <= 1e-6 * abs(auxc.item())


def test_moe_backward_is_bitwise_on_repeat(cuda):
    """The gradient of one MoE layer (the dispatch gather's backward sums
    a token's k rows in order; the combine's in one add a row) on the card
    twice: bitwise equal, and within TOL of the CPU's; then one SMOKE-
    width train step of the family (flash, remat) twice from one state:
    every leaf of the state bitwise equal."""
    from repro_torch.distributed import steps
    from repro_torch.models import layers
    from repro_torch.models.base import init_params
    from repro_torch.optim import AdamWConfig, adamw
    cfg = _moe_cfg()
    p = init_params(layers.moe_params(cfg), torch.Generator().manual_seed(0))
    x = torch.randn((2, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))

    def grads(dev):
        pd = [t.to(dev).requires_grad_() for t in adamw.tree_leaves(p)]
        xd = x.to(dev).requires_grad_()
        y, aux = layers.moe_apply(adamw.tree_unflatten(p, pd), xd, cfg)
        return [g.cpu() for g in torch.autograd.grad(
            (y * dy.to(dev)).sum() + aux, [xd, *pd])]
    first, again, cpu = grads(cuda), grads(cuda), grads("cpu")
    for a, b, c in zip(first, again, cpu):
        assert torch.equal(a, b)
        assert _rel(a, c) <= TOL
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    state = steps.init_train_state(cfg, opt,
                                   torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    runs = [steps.make_train_step(cfg, opt)(_to_device(state, cuda), batch)
            for _ in range(2)]
    for a, b in zip(adamw.tree_leaves(runs[0][0]),
                    adamw.tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][1]["loss"], runs[1][1]["loss"])
    assert all(bool(torch.isfinite(t).all())
               for t in adamw.tree_leaves(runs[0][0]))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_bf16_train_step_on_the_kernels(cuda, arch):
    """One SMOKE train step on bf16 params (remat, flash) on the card:
    only the bf16 routes launch (the conv1d forward twice a rec layer, dx
    and dw once; the flash forward twice and each backward kernel once
    an att layer), every leaf keeps its dtype and stays finite, and the
    loss is the CPU step's (the plain versions) within 1e-2: the same
    bf16 function, rounded in another order."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.optim import AdamWConfig, adamw
    cfg = registry.get(arch).SMOKE.replace(remat=True, attn_impl="flash")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    toks = torch.randint(2, cfg.vocab, (4, 65),
                         generator=torch.Generator().manual_seed(0))
    params = init_params(api.params(cfg), torch.Generator().manual_seed(1),
                         dtype=torch.bfloat16)
    losses = {}
    for dev in ("cpu", cuda):
        p = adamw.tree_unflatten(params, [t.to(dev, copy=True) for t in
                                          adamw.tree_leaves(params)])
        state = {"params": p, "opt": adamw.init_moments(p, opt),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        batch = {"tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        fa.reset_launch_counts()
        tc1.reset_launch_counts()
        state, metrics = steps.make_train_step(cfg, opt)(state, batch)
        losses[str(dev)] = float(metrics["loss"])
        for t, t0 in zip(adamw.tree_leaves(state["params"]),
                         adamw.tree_leaves(params)):
            assert t.dtype == t0.dtype and bool(torch.isfinite(t).all())
    rec = sum(cfg.pattern_at(i) == "rec" for i in range(cfg.n_layers)) \
        if cfg.family == "hybrid" else (
            cfg.n_layers if cfg.family == "ssm" else 0)
    att = cfg.n_layers - rec
    assert tc1.LAUNCHES == {"trim_conv1d": 0, "trim_conv1d_bf16": 2 * rec}
    assert tc1.BWD_LAUNCHES == _bwd_counts(tc1, trim_conv1d_dx_bf16=rec,
                                           trim_conv1d_wgrad_bf16=rec)
    assert fa.LAUNCHES == {"flash_attention": 0,
                           "flash_attention_bf16": 2 * att}
    assert fa.BWD_LAUNCHES == _bwd_counts(fa, **dict.fromkeys(
        ("flash_attention_bwd_dkdv_bf16", "flash_attention_bwd_dq_bf16",
         "flash_attention_bwd_sum_bf16"), att))
    assert abs(losses[str(cuda)] - losses["cpu"]) <= 1e-2 * abs(
        losses["cpu"])


def test_conv1d_wrapper_raises_on_cuda(cuda):
    from repro_torch.kernels import trim_conv1d as tc1
    x = torch.zeros((2, 8, 4), device=cuda)
    w = torch.zeros((4, 4), device=cuda)
    with pytest.raises(ValueError):
        tc1.trim_conv1d(x.half(), w.half())
    with pytest.raises(ValueError):
        tc1.trim_conv1d(x, w[:1])
    with pytest.raises(ValueError):
        tc1.trim_conv1d(x, w.cpu())


def test_mamba_prefill_on_the_kernel_matches_the_cpu(cuda):
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import steps
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    cfg = registry.get("falcon-mamba-7b").SMOKE
    p = init_params(api.params(cfg), torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 100),
                         generator=torch.Generator().manual_seed(1))
    want, want_tok = steps.make_prefill_step(cfg)(p, {"tokens": toks})
    pc = params_from_jax(p, device=cuda)       # the same tree, on the card
    tc1.reset_launch_counts()
    got, tok = steps.make_prefill_step(cfg)(pc, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert tc1.LAUNCHES["trim_conv1d"] == cfg.n_layers
    tol = 1e-5 * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol
    last = want[:, -1]
    picked = last.gather(1, tok.cpu()[:, None])[:, 0]
    assert bool(((tok.cpu() == want_tok)
                 | (last.amax(1) - picked <= 2 * tol)).all())


def test_hybrid_prefill_on_the_kernels_matches_decode(cuda):
    """recurrentgemma-2b at its published widths, cut to one (rec, rec,
    att) period with a 1024-token vocab and a 64-slot window: the flash
    prefill (2 conv1d launches, 1 flash launch) against token-by-token
    decode through the ring caches, past the wrap, at every position."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    cfg = registry.get("recurrentgemma-2b").CONFIG.replace(
        n_layers=3, vocab=1024, window=64)
    p = init_params(api.params(cfg), torch.Generator(device="cuda")
                    .manual_seed(0), device=cuda)
    n = 100
    toks = torch.randint(0, cfg.vocab, (2, n), device=cuda,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    fa.reset_launch_counts()
    tc1.reset_launch_counts()
    logits, _ = steps.make_prefill_step(cfg)(p, {"tokens": toks})
    assert fa.LAUNCHES["flash_attention"] == 1
    assert tc1.LAUNCHES["trim_conv1d"] == 2
    state = init_params(api.decode_state(cfg, 2, n), torch.Generator(),
                        device=cuda)
    with torch.no_grad():
        for t in range(n):
            step, state = api.decode(p, {
                "tokens": toks[:, t:t + 1],
                "cache_len": torch.full((2,), t + 1, dtype=torch.int32,
                                        device=cuda)}, state, cfg)
            err = ((step[:, 0] - logits[:, t]).abs().max()
                   / logits[:, t].abs().max()).item()
            assert err <= 1e-4, (t, err)
    assert fa.LAUNCHES["flash_attention"] == 1     # decode runs no kernel
    assert tc1.LAUNCHES["trim_conv1d"] == 2


# The int8 kernel (csrc/trim_conv2d_q8.cu) at its edges, on each route:
# dp4a (Cin/g 4 grouped, depthwise: Cin/g rounded up to a word), im2col
# (Cin 3 and 8; K 5 with Cin 3, past one k-step), mma (Cin/g a multiple
# of 16: Cin 16, 48 with its 16-channel tail, 96, 512), stride 2 and
# 'valid', a nonzero zero point as the 'same' padding (clip edges -128 and
# 127), no bias, Cout 8, 24 and 70 (one, three and ragged n8 fragments),
# tile_cout 3 and Cout % 4 != 0 (scalar stores), carry segments of several
# strips with the prefetching ring, N=1 at 14x14x512 (the small M tiles
# with warps split along k), and x at a 4-byte and a 1-byte offset (the
# 16-byte loader falls back to words, then to bytes).  Bitwise against the
# plain version for None / relu (exact int32 sums, one int32 add and one
# f32 multiply in both), within TOL for gelu / silu (the transcendentals);
# carry and halo bitwise equal.
Q8_CASES = [
    (2, 13, 11, 8, 12, 3, 1, 2, "same", "relu", 3, True, None, None, 0),
    (2, 13, 11, 8, 12, 3, 2, 2, "valid", None, -7, True, None, None, 0),
    (2, 10, 10, 3, 64, 3, 1, 1, "same", "relu", -128, True, None, None, 0),
    (2, 40, 40, 32, 32, 3, 1, 32, "same", "relu", 127, True, None, None, 0),
    (1, 12, 12, 8, 16, 3, 1, 1, "same", None, 5, False, None, None, 0),
    (8, 96, 96, 32, 64, 3, 1, 1, "same", "relu", 9, True, 2, None, 0),
    (2, 20, 33, 64, 70, 3, 1, 1, "same", "relu", -3, True, 4, 3, 0),
    (1, 16, 16, 512, 64, 3, 1, 1, "same", "relu", 17, True, None, None, 0),
    (2, 19, 23, 16, 24, 3, 2, 1, "same", "gelu", 6, True, None, None, 4),
    (2, 19, 23, 16, 24, 5, 2, 1, "same", "silu", 6, True, None, None, 1),
    (4, 56, 56, 128, 256, 3, 2, 1, "same", "relu", -1, True, None, None, 0),
    (2, 17, 15, 48, 40, 3, 1, 1, "same", "relu", 4, True, None, None, 0),
    (1, 15, 13, 96, 64, 3, 1, 1, "same", None, -5, True, None, None, 0),
    (2, 12, 12, 32, 8, 3, 1, 1, "same", "relu", 2, True, None, None, 0),
    (2, 12, 12, 32, 24, 3, 1, 1, "same", "silu", 2, False, None, None, 0),
    (2, 20, 33, 48, 70, 3, 1, 1, "same", "relu", -3, True, None, 3, 0),
    (2, 18, 18, 3, 16, 5, 1, 1, "same", "relu", -9, True, None, None, 0),
    (2, 21, 20, 64, 64, 3, 2, 1, "same", "relu", 11, True, None, None, 0),
    (2, 30, 30, 96, 128, 3, 2, 1, "valid", "gelu", -6, True, None, None, 0),
    (1, 14, 14, 512, 512, 3, 1, 1, "same", "relu", 3, True, None, None, 0),
]


def _q8_inputs(case, device):
    (n, h, w, cin, cout, k, s, g, padding, act, zp, bias, _, _,
     offset) = case
    gen = torch.Generator(device="cuda").manual_seed(h * w + cin)
    flat = torch.randint(-128, 128, (n * h * w * cin + offset,),
                         generator=gen, device=device, dtype=torch.int8)
    x = flat[offset:].view(n, h, w, cin)
    wt = torch.randint(-127, 128, (k, k, cin // g, cout), generator=gen,
                       device=device, dtype=torch.int8)
    bq = torch.randint(-2 ** 20, 2 ** 20, (cout,), generator=gen,
                       device=device, dtype=torch.int32) if bias else None
    scale = torch.rand((cout,), generator=gen, device=device) * 1e-3 + 1e-5
    kw = dict(zero_point=zp, stride=s, pad=conv_pads(h, w, k, s, padding),
              groups=g, activation=act)
    return x, wt, bq, scale, kw


@pytest.mark.parametrize("case", Q8_CASES,
                         ids=[str(i) for i in range(len(Q8_CASES))])
def test_q8_kernel_equals_plain(cuda, case):
    x, wt, bq, scale, kw = _q8_inputs(case, cuda)
    tile_h, tile_cout = case[12], case[13]
    plain = tc.trim_conv2d_q8_plain(x, wt, bq, scale, **kw)
    out = {}
    for df in ("carry", "halo"):
        before = tc.LAUNCHES[f"q8_{df}"]
        out[df] = tc.trim_conv2d_q8(x, wt, bq, scale, dataflow=df,
                                    tile_h=tile_h, tile_cout=tile_cout,
                                    **kw)
        assert tc.LAUNCHES[f"q8_{df}"] == before + 1
    torch.cuda.synchronize()
    assert out["carry"].dtype == torch.float32
    assert torch.equal(out["carry"], out["halo"])
    if kw["activation"] in (None, "relu"):
        assert torch.equal(out["carry"], plain)
    else:
        tol = TOL * max(1.0, plain.abs().max().item())
        assert (out["carry"] - plain).abs().max().item() <= tol


def test_q8_kernel_is_batch_invariant_and_takes_packed_weights(cuda):
    x, wt, bq, scale, kw = _q8_inputs(Q8_CASES[0], cuda)
    full = tc.trim_conv2d_q8(x, wt, bq, scale,
                             w_packed=tc.pack_q8_weights(wt), **kw)
    for i in range(x.shape[0]):
        one = tc.trim_conv2d_q8(x[i:i + 1].contiguous(), wt, bq, scale, **kw)
        assert torch.equal(one[0], full[i])


def test_q8_calibrated_layer_on_the_card_equals_the_cpu(cuda):
    """ops.conv2d on calibrated weights: the quantize pass, the dequant
    parameters and the kernel on the card equal the CPU's bit for bit."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 28, 28, 64), generator=gen) + 0.2
    p = layers.calibrate_conv2d(
        {"w": torch.randn((3, 3, 64, 96), generator=gen) * 0.05,
         "b": torch.randn((96,), generator=gen)}, x)
    pk = p["packed"]
    pc = pk.to(cuda)
    assert torch.equal(ref.quantize_int8(x.to(cuda), pc.input_scale,
                                         pc.zero_point).cpu(),
                       ref.quantize_int8(x, pk.input_scale, pk.zero_point))
    want = ops.conv2d(x, pk, activation="relu")
    for df in ("carry", "halo"):
        got = ops.conv2d(x.to(cuda), pc, activation="relu", dataflow=df)
        assert torch.equal(got.cpu(), want)


def test_q8_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    x, wt, bq, scale, kw = _q8_inputs(Q8_CASES[0], cuda)
    with pytest.raises(ValueError):
        tc.trim_conv2d_q8(x, wt.cpu(), bq, scale, **kw)
    with pytest.raises(ValueError):
        tc.trim_conv2d_q8(x, wt, bq, scale, w_packed=wt, **kw)
    with pytest.raises(ValueError):
        tc.trim_conv2d_q8(x.permute(0, 2, 1, 3), wt, bq, scale, **kw)
    with pytest.raises(TypeError):
        tc.trim_conv2d_q8(x.float(), wt, bq, scale, **kw)
    with pytest.raises(ValueError):      # window beyond shared memory
        tc.trim_conv2d_q8(
            torch.zeros((1, 8, 8, 65536), dtype=torch.int8, device=cuda),
            torch.zeros((3, 3, 65536, 4), dtype=torch.int8, device=cuda),
            None, torch.ones(4, device=cuda), pad=1)


def test_q8_launcher_takes_and_checks_the_plan(cuda):
    """The plan's route and warps reach the int8 launcher, which refuses
    a route its own constants do not give and a warp layout it cannot
    run; the plan's own launch goes through."""
    from repro_torch.core.conv_plan import Q8_ROUTES, ConvPlan
    from repro_torch.kernels import build
    lib = build.library("trim_conv2d_q8")
    x, wt, bq, scale, kw = _q8_inputs(Q8_CASES[7], cuda)     # Cin 512: mma
    plan = ConvPlan.build(tuple(x.shape), tuple(wt.shape), stride=1,
                          pad=kw["pad"], dtype_bytes=1)
    wp = tc.pack_q8_weights(wt)
    y = torch.empty(plan.out_shape, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(route, warps_n, warps_k, m_frags):
        return lib.trim_conv2d_q8_carry(
            x.data_ptr(), wp.data_ptr(), bq.data_ptr(), scale.data_ptr(),
            y.data_ptr(), plan.n, plan.h, plan.w, plan.cin, plan.cout,
            plan.kh, plan.stride, plan.pads[0][0], plan.pads[1][0],
            plan.groups, plan.h_out, plan.w_out, plan.th_out, plan.tile_w,
            plan.tile_cout, plan.strips_per_segment, plan.ring_rows,
            plan.cin_stride, kw["zero_point"], 1, route, warps_n, warps_k,
            m_frags, stream)

    assert plan.route == "mma"
    mma = Q8_ROUTES.index("mma")
    assert launch(mma, plan.warps_n, plan.warps_k, plan.m_frags) == 0
    torch.cuda.synchronize()
    assert torch.equal(y, tc.trim_conv2d_q8_plain(
        x, wt, bq, scale, zero_point=kw["zero_point"], pad=kw["pad"],
        activation="relu"))
    assert launch(Q8_ROUTES.index("im2col"), plan.warps_n, plan.warps_k,
                  plan.m_frags) != 0
    assert launch(Q8_ROUTES.index("dp4a"), 0, 0, 0) != 0
    assert launch(mma, 3, 1, 1) != 0
    assert launch(mma, plan.warps_n, 2, 2) != 0


# (x_shape, w_shape, stride, groups): three shapes for the measured tune
TUNE_CASES = [((2, 28, 28, 64), (3, 3, 64, 128), 1, 1),
              ((1, 14, 14, 256), (3, 3, 256, 256), 1, 1),
              ((4, 30, 30, 32), (3, 3, 32, 96), 2, 1)]


def test_measured_tune_on_the_card_writes_a_measured_record(cuda):
    from repro_torch.core import autotune
    xs, ws, stride, groups = TUNE_CASES[0]
    pads = conv_pads(xs[1], xs[2], ws[0], stride, "same")
    rec = autotune.tune(xs, ws, stride=stride, pad=pads, groups=groups,
                        measure=True, device=cuda)
    assert rec["source"] == "measured" and rec["measured_us"] > 0
    key = autotune.make_key(xs, ws, stride=stride, pad=pads, device=cuda)
    assert ":float32:cuda:sm" in key
    autotune.reset_memory_cache()
    assert autotune.knobs_for(xs, ws, stride=stride, pad=pads,
                              device=cuda) == rec
    # the CPU's key is another record
    assert autotune.knobs_for(xs, ws, stride=stride, pad=pads,
                              device="cpu") is None


@pytest.mark.parametrize("case", TUNE_CASES, ids=["n2c64", "n1c256", "s2"])
def test_tuned_knobs_give_the_default_output_bitwise(cuda, case):
    """Every f32 output is one fmaf chain and every int8 sum exact, so a
    tuned plan (tiles and dataflow) equals the default plan bit for bit:
    carry, halo and int8, and through ``ops.conv2d`` on the record."""
    from repro_torch.core import autotune
    xs, ws, stride, groups = case
    pads = conv_pads(xs[1], xs[2], ws[0], stride, "same")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(xs, generator=gen, device=cuda)
    w = torch.randn(ws, generator=gen, device=cuda) * 0.05
    b = torch.randn((ws[3],), generator=gen, device=cuda)
    kw = dict(stride=stride, pad=pads, groups=groups, activation="relu")
    default = tc.trim_conv2d(x, w, b, **kw)
    rec = autotune.tune(xs, ws, stride=stride, pad=pads, groups=groups,
                        measure=True, device=cuda)
    for dataflow in ("carry", "halo"):
        got = tc.trim_conv2d(x, w, b, tile_h=rec["tile_h"],
                             tile_cout=rec["tile_cout"], dataflow=dataflow,
                             **kw)
        assert torch.equal(got, default), dataflow
    tc.reset_launch_counts()
    got = ops.conv2d(x, w, stride=stride, bias=b, activation="relu",
                     feature_group_count=groups)
    assert torch.equal(got, default)
    assert tc.LAUNCHES[rec["dataflow"]] == 1
    # int8: exact sums, any plan
    x8 = torch.randint(-128, 128, xs, generator=gen, device=cuda,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, ws, generator=gen, device=cuda,
                       dtype=torch.int8)
    scale = torch.full((ws[3],), 1e-3, device=cuda)
    qkw = dict(stride=stride, pad=pads, groups=groups, zero_point=3)
    q_default = tc.trim_conv2d_q8(x8, w8, None, scale, **qkw)
    qrec = autotune.tune(xs, ws, stride=stride, pad=pads, groups=groups,
                         dtype="int8", measure=True, device=cuda)
    assert qrec["source"] == "measured"
    for dataflow in ("carry", "halo"):
        got = tc.trim_conv2d_q8(x8, w8, None, scale, tile_h=qrec["tile_h"],
                                tile_cout=qrec["tile_cout"],
                                dataflow=dataflow, **qkw)
        assert torch.equal(got, q_default), dataflow


# The geometries of the DAG topologies at full width: ResNet-18's stem
# (7x7/2 'same' at Cin 3, XLA pads 2 / 3, virtual here) at batch 8 and 1,
# its 1x1/2 'valid' down-projection 64->128 at 56 x 56 (KH < stride: no
# carried rows, every other input row skipped) and U-Net's 1x1 'valid'
# head.  (n, h, cin, cout, k, stride, padding)
GRAPH_CASES = [
    (8, 224, 3, 64, 7, 2, "same"),
    (1, 224, 3, 64, 7, 2, "same"),
    (8, 56, 64, 128, 1, 2, "valid"),
    (8, 64, 16, 4, 1, 1, "valid"),
]


@pytest.mark.parametrize("case", GRAPH_CASES,
                         ids=["stem_n8", "stem_n1", "down_1x1s2", "head_1x1"])
def test_graph_geometries_match_plain(cuda, case):
    n, h, cin, cout, k, s, padding = case
    gen = torch.Generator(device="cuda").manual_seed(h + k)
    x = torch.randn((n, h, h, cin), generator=gen, device=cuda)
    wt = torch.randn((k, k, cin, cout), generator=gen, device=cuda) \
        / (k * cin ** 0.5)
    b = torch.randn((cout,), generator=gen, device=cuda)
    pads = conv_pads(h, h, k, s, padding)
    kw = dict(stride=s, pad=pads, activation="relu")
    plain = tc.trim_conv2d_plain(x, wt, b, **kw)
    out = {df: tc.trim_conv2d(x, wt, b, dataflow=df, **kw)
           for df in ("carry", "halo")}
    torch.cuda.synchronize()
    tol = TOL * max(1.0, plain.abs().max().item())
    for df, y in out.items():
        assert y.shape == plain.shape
        assert (y - plain).abs().max().item() <= tol, df
    assert torch.equal(out["carry"], out["halo"])
    gy = torch.randn(plain.shape, generator=gen, device=cuda)
    wkw = dict(kernel_size=k, stride=s, pad=pads)
    dw_plain = tc.trim_conv2d_weight_grad_plain(x, gy, **wkw)
    one = tc.trim_conv2d_weight_grad(x, gy, **wkw)
    two = tc.trim_conv2d_weight_grad(x, gy, **wkw)
    assert (one - dw_plain).abs().max().item() <= \
        TOL * dw_plain.abs().max().item()
    assert torch.equal(one, two)
    want = ref.conv2d_input_grad(x, wt, gy, stride=s, padding=padding)
    for df in ("carry", "halo"):
        got = tc.trim_conv2d_input_grad(gy, wt, x_shape=tuple(x.shape),
                                        stride=s, pad=pads, dataflow=df)
        assert (got - want).abs().max().item() <= \
            TOL * max(1.0, want.abs().max().item()), df


@pytest.mark.parametrize("net", ["resnet18", "unet"])
def test_graph_plan_groups_equal_their_chains(cuda, net):
    """The groups the plans fuse on the card: ResNet-18 layer1's no-pool
    pairs (3x3, 64 channels, 56 x 56) and U-Net's, the last of which ends
    in the 1x1 head, at batch 8, against the plain version and bitwise
    against the per-layer chain, forward and gradients."""
    from repro_torch.core.fuse_plan import GraphFusePlan
    from repro_torch.kernels import trim_conv2d_fused as tfu
    groups = [g for g in GraphFusePlan.build(net, n=8).groups if g.fused]
    assert groups and (net != "unet" or groups[-1].last.kernel == 1)
    gen = torch.Generator(device="cuda").manual_seed(17)
    for g in groups:
        s0 = g.stages[0]
        x = torch.randn((g.n, s0.h_in, s0.w_in, s0.cin), generator=gen,
                        device=cuda)
        ws = [torch.randn(st.weight_shape, generator=gen, device=cuda)
              / (st.kernel * st.cin ** 0.5) for st in g.stages]
        bs = [torch.randn((st.cout,), generator=gen, device=cuda)
              for st in g.stages]
        before = tc.LAUNCHES["fused"]
        one = tfu.trim_conv2d_fused(x, ws, bs, group=g)
        assert tc.LAUNCHES["fused"] == before + 1
        plain = tfu.trim_conv2d_fused_plain(x, ws, bs, group=g)
        assert (one - plain).abs().max().item() <= \
            TOL * max(1.0, plain.abs().max().item()), g.label
        assert torch.equal(one, tfu.reference_chain(x, ws, bs, group=g)), \
            g.label
        gy = torch.randn(g.out_shape, generator=gen, device=cuda)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
            d = g.depth
            y = fn(leaves[0], leaves[1:1 + d], leaves[1 + d:], group=g)
            return torch.autograd.grad(y, leaves, gy)
        for a, c in zip(grads(tfu.fused_group_apply),
                        grads(tfu.reference_chain)):
            assert torch.equal(a, c), g.label


@pytest.mark.parametrize("net", ["resnet18", "unet"])
def test_tiny_graphs_on_the_card(cuda, net):
    """``tests/test_torch_graph.py``'s tiny graphs through
    ``cnn_apply_from_graph`` on the kernels: halo and fused (the plan's,
    and for ResNet-18 layer1's pairs forced into fused groups) equal
    carry bitwise, carry against ``impl="ref"``; the same on the CPU's
    plain versions within TOL."""
    import dataclasses
    from repro_torch.core.fuse_plan import GraphFusePlan, build_group
    from repro_torch.core.model import resnet18_graph, unet_graph
    from repro_torch.core.netplan import scale_graph
    from repro_torch.models import layers
    nodes = (scale_graph(resnet18_graph(image=32, base=8), 2)
             if net == "resnet18" else unet_graph(image=16, base=4, depth=2))
    model = layers.TrimCNN.random(nodes, n_classes=5, device=cuda)
    src = nodes[0].layer
    x = torch.randn((2, src.ifmap, src.ifmap, src.in_channels),
                    generator=torch.Generator(device="cuda").manual_seed(2),
                    device=cuda)
    plan = GraphFusePlan.build(nodes, n=2)
    segs = []
    for names, p in plan.segments:
        if names[0].startswith("l1b"):
            g = build_group([nd.layer for nd in nodes if nd.name in names],
                            0, n=2, strip_rows=2, band_cols=3)
            p = dataclasses.replace(p, groups=(g,))
        segs.append((names, p))
    forced = dataclasses.replace(plan, segments=tuple(segs))
    tree = model.tree()
    with torch.no_grad():
        carry = layers.cnn_apply_from_graph(tree, nodes, x)
        for kw in (dict(dataflow="halo"), dict(fused=True),
                   dict(fuse_plan=forced)):
            assert torch.equal(layers.cnn_apply_from_graph(
                tree, nodes, x, **kw), carry), kw
        want = layers.cnn_apply_from_graph(tree, nodes, x, impl="ref")
        cpu = layers.cnn_apply_from_graph(
            {k: {m: t.cpu() for m, t in v.items()} for k, v in tree.items()},
            nodes, x.cpu())
    tol = TOL * max(1.0, want.abs().max().item())
    assert (carry - want).abs().max().item() <= tol
    assert (carry.cpu() - cpu).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# The bf16 routes: trim_conv2d_carry_bf16 / _halo_bf16 and
# trim_conv2d_fused_bf16.  Their plain versions take the kernels' own fmaf
# chain (products exact in f32), so the two agree bit for bit where the
# epilogue is exact (none, relu) and within one bf16 ulp where CUDA's and
# PyTorch's tanh / exp may differ in the last f32 bit (gelu, silu).
# ---------------------------------------------------------------------------

def _bf16_ulps(a, b) -> float:
    """max |a - b| in bf16 ulps at max(|a|, |b|) (of the normal range)."""
    a, b = a.double(), b.double()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.pow(2.0, torch.floor(torch.log2(m)) - 7)
    return ((a - b).abs() / ulp).max().item()


# the f32 edge cases in bf16; an offset of one element is 2 bytes (plain
# loads of the window and the weights)
BF16_CASES = [c + (0,) for c in CASES] + [
    (n, h, w, cin, cout, k, s, g, "same", "relu", tile_h, tile_cout,
     int(off)) for n, h, w, cin, cout, k, s, g, tile_h, tile_cout, off
    in EDGE_CASES]


def _bf16_f64_excess(y, x, w, b, *, stride, pad, groups, act):
    """How far a bf16 conv output lies beyond its bound from the float64
    oracle rounded to bf16 (<= 0: within): one bf16 ulp of the oracle plus
    n 2^-22 sum|x w| (n = KH KW Cin/g products: the f32 chain's n 2^-24
    bound, tests/test_torch_bf16.py, doubled twice for the tensor core's
    truncating additions), times the activation's largest slope (gelu
    1.13, silu 1.10)."""
    import torch.nn.functional as F
    (pt, pb), (pl, pr) = pad
    xd = F.pad(x.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    wd = w.double().permute(3, 2, 0, 1)
    acc = F.conv2d(xd, wd, stride=stride, groups=groups)
    mass = F.conv2d(xd.abs(), wd.abs(), stride=stride, groups=groups)
    want = ref.epilogue(acc.permute(0, 2, 3, 1), None if b is None
                        else b.double(), act).bfloat16().double()
    n = w.shape[0] * w.shape[1] * w.shape[2]
    slope = 1.0 if act in (None, "relu") else 1.2
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    bound = ulp + slope * n * 2.0 ** -22 * mass.permute(0, 2, 3, 1)
    return ((y.double() - want).abs() - bound).max().item()


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=[str(i) for i in range(len(BF16_CASES))])
def test_bf16_kernels_match_plain_within_an_ulp(cuda, case):
    """Route ffma (the fmaf chain): bitwise the plain version where the
    epilogue is exact, within one ulp otherwise.  Route mma (Cin/g a
    multiple of 16: the bf16 tensor cores, whose additions the CPU cannot
    repeat): within the float64 oracle's bound (``_bf16_f64_excess``).
    Either route: carry == halo and a row alone bitwise."""
    from repro_torch.core.conv_plan import bf16_route
    n, h, w, cin, cout, k, s, g, padding, act, tile_h, tile_cout, off = case
    gen = torch.Generator(device="cuda").manual_seed(len(BF16_CASES))

    def draw(shape, scale=1.0):
        flat = torch.randn((off + torch.Size(shape).numel(),),
                           generator=gen, device=cuda) * scale
        return flat.bfloat16()[off:].view(shape)
    x = draw((n, h, w, cin))
    wt = draw((k, k, cin // g, cout), (k * k * cin // g) ** -0.5)
    b = draw((cout,))
    kw = dict(stride=s, pad=conv_pads(h, w, k, s, padding), groups=g,
              activation=act)
    plain = tc.trim_conv2d_plain(x, wt, b, **kw)
    out = {}
    for df in ("carry", "halo"):
        before = dict(tc.LAUNCHES)
        out[df] = tc.trim_conv2d(x, wt, b, dataflow=df, tile_h=tile_h,
                                 tile_cout=tile_cout, **kw)
        assert tc.LAUNCHES[f"{df}_bf16"] == before[f"{df}_bf16"] + 1
        assert tc.LAUNCHES[df] == before[df]
    torch.cuda.synchronize()
    mma = bf16_route(cin // g, g) == "mma"
    for df, y in out.items():
        assert y.dtype == torch.bfloat16 and y.shape == plain.shape
        if mma:
            assert _bf16_f64_excess(y, x, wt, b, stride=s, pad=kw["pad"],
                                    groups=g, act=act) <= 0, df
        else:
            if act in (None, "relu"):
                assert torch.equal(y, plain), df
            assert _bf16_ulps(y, plain) <= 1.0, df
    assert torch.equal(out["carry"], out["halo"])
    # batch invariance: a row alone gives the same bits
    one = tc.trim_conv2d(x[:1].contiguous(), wt, b, **kw)
    assert torch.equal(one[0], out["carry"][0])


@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=[str(i) for i in range(len(FUSED_CASES))])
def test_bf16_fused_kernel_equals_the_chain_bitwise(cuda, case):
    from repro_torch.core.fuse_plan import BF16FusedGroup, build_group
    from repro_torch.core.model import ConvLayer
    from repro_torch.kernels import trim_conv2d_fused as tfu
    spec, act, with_bias, tiles = case
    topo = [ConvLayer(*a) for a in spec]
    gen = torch.Generator(device="cuda").manual_seed(len(FUSED_CASES) + 1)
    x = torch.randn((2, topo[0].ifmap, topo[0].ifmap, topo[0].in_channels),
                    generator=gen, device=cuda).bfloat16()
    ws = [(torch.randn((l.kernel, l.kernel, l.in_channels, l.out_channels),
                       generator=gen, device=cuda)
           / (l.kernel * l.in_channels ** 0.5)).bfloat16() for l in topo]
    bs = [torch.randn((l.out_channels,), generator=gen, device=cuda)
          .bfloat16() if with_bias else None for l in topo]
    chain = tfu.reference_chain(x, ws, bs, group=build_group(topo, 0, n=2),
                                activation=act)
    for t, b in tiles:
        g = build_group(topo, 0, n=2, strip_rows=t, band_cols=b,
                        dtype_bytes=2)
        assert isinstance(g, BF16FusedGroup)
        before = tc.LAUNCHES["fused_bf16"]
        one = tfu.trim_conv2d_fused(x, ws, bs, group=g, activation=act)
        two = tfu.trim_conv2d_fused(x, ws, bs, group=g, activation=act)
        torch.cuda.synchronize()
        assert tc.LAUNCHES["fused_bf16"] == before + 2
        plain = tfu.trim_conv2d_fused_plain(x, ws, bs, group=g,
                                            activation=act)
        assert one.dtype == torch.bfloat16 and one.shape == g.out_shape
        assert torch.equal(one, two), (t, b)
        assert torch.equal(one, chain), (t, b)
        # the plain version is the fmaf chain: bitwise where every stage
        # takes it (route ffma) and the epilogue is exact
        if act in (None, "relu") and all(
                lay.route == "ffma" for lay in g.layouts):
            assert torch.equal(one, plain), (t, b)
        else:   # stage by stage, an ulp may carry into the next stage
            assert (one.float() - plain.float()).abs().max().item() <= \
                3e-2 * plain.float().abs().max().item(), (t, b)


def test_bf16_cuda_calls_never_reach_the_plain_versions(cuda, monkeypatch):
    """A bf16 CUDA tensor launches its kernel or raises: spies on the plain
    versions stay at zero calls through ops.conv2d (K 3 and the K 11
    adder tree), the fused group and a bf16 network served per layer and
    fused."""
    from repro_torch.core.model import ConvLayer
    from repro_torch.core.serving import ServingEngine
    from repro_torch.kernels import trim_conv2d_fused as tfu
    from repro_torch.models import layers
    calls = []
    for mod, name in ((tc, "trim_conv2d_plain"),
                      (tfu, "trim_conv2d_fused_plain")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 23, 23, 8), generator=gen, device=cuda).bfloat16()
    w3 = torch.randn((3, 3, 8, 16), generator=gen, device=cuda).bfloat16()
    w11 = torch.randn((11, 11, 8, 16), generator=gen,
                      device=cuda).bfloat16()
    tc.reset_launch_counts()
    assert ops.conv2d(x, w3).dtype == torch.bfloat16
    ops.conv2d(x, w11, stride=4, padding="valid")
    assert tc.LAUNCHES["carry_bf16"] == 1 + ops.conv_launches(11)
    topo = [ConvLayer("a", 16, 3, 8, 3, padding=1),
            ConvLayer("b", 16, 8, 8, 3, padding=1),
            ConvLayer("c", 8, 8, 16, 3, padding=1)]
    model = layers.TrimCNN.random(topo, n_classes=4, device=cuda,
                                  dtype=torch.bfloat16)
    xs = torch.randn((2, 16, 16, 3), generator=gen, device=cuda).cpu()
    rows = {}
    for fused in (False, True):
        eng = ServingEngine.for_topology(topo, model, buckets=(1, 2),
                                         device=cuda, fused=fused)
        rows[fused] = [eng.forward_one(r) for r in xs.numpy()]
    assert all((a == b).all() for a, b in zip(rows[False], rows[True]))
    assert tc.LAUNCHES["fused_bf16"] >= 2
    assert calls == []
    assert tc.LAUNCHES["carry"] == tc.LAUNCHES["fused"] == 0


# bf16 conv1d: the f32 cases (every K instance, ragged runs, strided
# views; 8 channels a lane where D % 8 == 0), plus rows at a 2-byte
# offset (one channel a lane)
CONV1D_BF16_CASES = CONV1D_CASES + [(2, 300, 64, 4, None, "offset"),
                                    (1, 50, 40, 9, 3, "offset")]


@pytest.mark.parametrize("case", CONV1D_BF16_CASES,
                         ids=[str(i) for i in range(len(CONV1D_BF16_CASES))])
def test_conv1d_bf16_kernel_equals_plain_bitwise(cuda, case):
    """The bf16 route: f32 sums of exact products, one rounding at the
    store, so the kernel equals its plain version bit for bit; counted
    under ``trim_conv1d_bf16`` and never under the f32 route."""
    from repro_torch.kernels import trim_conv1d as tc1
    b, length, d, k, tile_l, view = case
    gen = torch.Generator(device="cuda").manual_seed(length + d + 1)
    width = 2 * d if view is True else d + 1 if view == "offset" else d
    xz = torch.randn((b, length, width), generator=gen,
                     device=cuda).bfloat16()
    x = xz[..., 1:d + 1] if view == "offset" else xz[..., :d]
    w = (0.5 * torch.randn((k, d), generator=gen, device=cuda)).bfloat16()
    assert tc1.bf16_vec(x, w) == (8 if d % 8 == 0 and view != "offset"
                                  else 1)
    before = dict(tc1.LAUNCHES)
    out = tc1.trim_conv1d(x, w, tile_l=tile_l)
    again = tc1.trim_conv1d(x, w, tile_l=tile_l)
    torch.cuda.synchronize()
    assert tc1.LAUNCHES["trim_conv1d_bf16"] == before["trim_conv1d_bf16"] + 2
    assert tc1.LAUNCHES["trim_conv1d"] == before["trim_conv1d"]
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.equal(out, tc1.trim_conv1d_plain(x, w, tile_l=tile_l))
    assert torch.equal(out, again)


# bf16 flash: D 16, 128 and 256 (the narrow route's three instances, the
# SMOKE, qwen2.5-3b and recurrentgemma-2b head dims), 14 (element-wise
# K / V loads), 320 (the wide route); GQA, windows, soft caps, Lq < Lk
FLASH_BF16_CASES = [
    (2, 40, 40, 4, 2, 16, True, None, None),
    (1, 33, 100, 7, 1, 14, False, None, 20),
    (1, 300, 300, 16, 2, 128, True, None, None),
    (2, 17, 1000, 16, 2, 128, True, None, None),
    (1, 150, 150, 10, 1, 256, True, 30.0, 70),
    (1, 150, 150, 4, 2, 320, True, None, None),
    (2, 70, 130, 6, 2, 320, False, 30.0, 40),
    # seamless-m4t-large-v2's cross calls (MHA, D 64, non-causal)
    (2, 100, 300, 16, 16, 64, False, None, None),
    (2, 300, 100, 16, 16, 64, False, None, None),
]
FLASH_BF16_TOL = 1e-2
# past half an ulp of bf16, of max|o|, from the float64 plain version:
# f32 inside leaves ~1e-6, one bf16 P ~7e-4 (chip_smoke's
# FLASH_BF16_F64_EXCESS; tests/test_torch_bf16_wgrad_flash.py)
FLASH_BF16_F64_EXCESS = 2.0 ** -14
# the bf16 backward's dq, dk, dv likewise, of max|grad|: the P and dS
# splits leave ~1e-6, one bf16 P or dS ~1e-3 (chip_smoke's
# FLASH_BWD_BF16_F64_EXCESS; tests/test_torch_bf16_wgrad_flash.py)
FLASH_BWD_BF16_F64_EXCESS = 2.0 ** -14


@pytest.mark.parametrize("case", FLASH_BF16_CASES,
                         ids=[str(i) for i in range(len(FLASH_BF16_CASES))])
def test_flash_bf16_kernel_matches_plain(cuda, case):
    """bf16 q, k, v: the kernel within 1e-2 of max|o| of its plain
    version (both f32 inside, one rounding to bf16 at the end; the
    tolerance is DESIGN.md's bf16 one) and within half an ulp of bf16
    plus ``FLASH_BF16_F64_EXCESS`` of max|o| of the float64 plain
    version (the narrow route's P split keeps P f32; one bf16 P does
    not), counted under ``flash_attention_bf16`` only, repeatable
    bitwise."""
    from repro_torch.kernels import flash_attention as fa
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator(device="cuda").manual_seed(lq + lk + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).bfloat16()
               for shape in ((b, lq, hq, d), (b, lk, hkv, d),
                             (b, lk, hkv, d)))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bf16"] == \
        before["flash_attention_bf16"] + 2
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"]
    plain = fa.flash_attention_plain(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == plain.shape
    scale = plain.float().abs().max().item()
    assert (out.float() - plain.float()).abs().max().item() <= \
        FLASH_BF16_TOL * scale
    want = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                    **kw)
    of = out.float()
    half = torch.where(of == 0, torch.zeros_like(of),
                       torch.ldexp(torch.ones_like(of),
                                   torch.frexp(of)[1] - 9))
    excess = ((of.double() - want).abs() - half.double()).max().item()
    assert excess <= FLASH_BF16_F64_EXCESS * want.abs().max().item()
    assert torch.equal(out, again)


def test_bf16_lm_calls_never_reach_the_plain_versions(cuda, monkeypatch):
    """A bf16 SMOKE prefill of each family on the card launches the bf16
    routes (conv1d and flash) and calls no plain version."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    calls = []
    for mod, name in ((fa, "flash_attention_plain"), (fa, "_plain_forward"),
                      (tc1, "trim_conv1d_plain")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    # launches of a 3-layer prefill: (conv1d, flash)
    want = {"qwen2.5-3b": (0, 3), "falcon-mamba-7b": (3, 0),
            "recurrentgemma-2b": (2, 1)}
    for arch, (n_conv, n_att) in want.items():
        cfg = registry.get(arch).SMOKE.replace(
            n_layers=3, dtype="bfloat16", attn_impl="flash")
        p = init_params(api.params(cfg), torch.Generator().manual_seed(0),
                        device=cuda, dtype=torch.bfloat16)
        tokens = torch.randint(0, cfg.vocab, (2, 24), device=cuda)
        fa.reset_launch_counts()
        tc1.reset_launch_counts()
        logits, _ = steps.make_prefill_step(cfg)(p, {"tokens": tokens})
        torch.cuda.synchronize()
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())
        assert tc1.LAUNCHES == {"trim_conv1d": 0,
                                "trim_conv1d_bf16": n_conv}
        assert fa.LAUNCHES == {"flash_attention": 0,
                               "flash_attention_bf16": n_att}
    assert calls == []


# bf16 weight gradient: the geometries of tests/test_torch_bf16_train.py's
# (a) (K 3 at strides 1 and 2, 'same' and 'valid', groups 2, depthwise,
# Cin 3 and K 11's rectangular sub-kernels), ragged chunks and 128-column
# tiles, VGG-16 conv2 at 1/2 the image, the smoke's depthwise case and
# operands at a 2-byte offset: on route gemm (Cin 8, the one-element
# loaders) and on route mma (Cin 16, Cout 24: the wrapper copies them to
# 16-byte alignment).
# (n, h, w, cin, cout, kh, kw, stride, groups, padding, tile_go, offset)
WGRAD_BF16_CASES = [
    (2, 11, 12, 8, 16, 3, 3, 1, 1, "same", None, 0),
    (2, 11, 12, 8, 16, 3, 3, 1, 1, "valid", 2, 0),
    (2, 11, 12, 8, 16, 3, 3, 2, 1, "same", None, 0),
    (2, 11, 12, 8, 16, 3, 3, 2, 1, "valid", None, 0),
    (2, 10, 9, 8, 12, 3, 3, 1, 2, "same", 3, 0),
    (2, 10, 10, 8, 8, 3, 3, 2, 8, "same", None, 0),
    (2, 13, 12, 3, 16, 3, 3, 1, 1, "same", 4, 0),
    (2, 19, 18, 3, 16, 3, 2, 4, 1, "valid", None, 0),
    (2, 18, 19, 3, 16, 2, 3, 4, 1, "valid", None, 0),
    (2, 18, 18, 3, 16, 2, 2, 4, 1, "valid", None, 0),
    (3, 15, 15, 40, 130, 3, 3, 1, 1, "same", 4, 0),
    (8, 112, 112, 64, 64, 3, 3, 1, 1, "same", None, 0),
    (8, 112, 112, 32, 32, 3, 3, 1, 32, "same", None, 0),
    (2, 19, 23, 16, 24, 3, 3, 2, 1, "same", None, 1),
    (2, 19, 23, 8, 16, 3, 3, 2, 1, "same", None, 1),
    # route mma: ragged chunks, 128-column and half-empty 128-row tiles,
    # groups of 16 channels, a 3x2 tap set
    (2, 13, 11, 64, 136, 3, 3, 1, 1, "same", 3, 0),
    (2, 12, 12, 32, 16, 3, 3, 1, 2, "same", 2, 0),
    (1, 10, 9, 48, 64, 3, 2, 1, 1, "valid", None, 0),
    (8, 28, 28, 256, 512, 3, 3, 1, 1, "same", None, 0),
]


def _wgrad_f64_excess(dw, x, gy, plan):
    """How far f32 weight-gradient sums lie beyond their float64 bound
    (<= 0: within): (P + C) 2^-22 sum|x dz|, P a chunk's positions, C
    its chunks (``chip_smoke.wgrad_f64_excess``)."""
    import torch.nn.functional as F
    (pt, pb), (pl, pr) = plan.pads
    xd = F.pad(x.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    gd = gy.double().permute(0, 3, 1, 2)
    wsize = (plan.cout, plan.cin_per_group, plan.kh, plan.kw)
    kw = dict(stride=plan.stride, groups=plan.groups)
    want = torch.nn.grad.conv2d_weight(xd, wsize, gd, **kw)
    mass = torch.nn.grad.conv2d_weight(xd.abs(), wsize, gd.abs(), **kw)
    n = plan.tile_go * plan.w_out + plan.chunks
    return ((dw.double().permute(3, 2, 0, 1) - want).abs()
            - n * 2.0 ** -22 * mass).max().item()


@pytest.mark.parametrize("case", WGRAD_BF16_CASES,
                         ids=[str(i) for i in range(len(WGRAD_BF16_CASES))])
def test_bf16_wgrad_is_the_f32_entry_on_widened_operands(cuda, case):
    """On routes gemm and depthwise ``trim_conv2d_wgrad_bf16`` widens its
    operands into the f32 kernel's stages: its f32 sums are bitwise the
    f32 entry's on the widened operands (a bf16 product is exact in f32;
    the same plan, so the same chunks and order).  On route mma (Cin/g %
    16 == 0, Cout/g % 8 == 0: the bf16 tensor cores, whose sum no f32
    path repeats) they lie within the float64 bound
    (``_wgrad_f64_excess``); a misaligned operand is copied, not refused.
    Either route: repeatable, and within TOL of max|plain| of the plain
    version.  Counted under ``wgrad_bf16`` only."""
    from repro_torch.core.conv_plan import WeightGradPlan
    n, h, w, cin, cout, kh, kw, s, g, padding, tile_go, offset = case
    gen = torch.Generator(device="cuda").manual_seed(h * w + cout)
    pads = conv_pads(h, w, kh, s, padding) if kh == kw else \
        ((0, 0), (0, 0))
    ho = (h + sum(pads[0]) - kh) // s + 1
    wo = (w + sum(pads[1]) - kw) // s + 1

    def draw(shape):
        size = 1
        for d in shape:
            size *= d
        t = torch.randn((size + offset,), generator=gen, device=cuda)
        return t.bfloat16()[offset:].view(shape)
    x, gy = draw((n, h, w, cin)), draw((n, ho, wo, cout))
    kw_ = dict(kernel_size=(kh, kw), stride=s, pad=pads, groups=g,
               tile_go=tile_go)
    before = dict(tc.LAUNCHES)
    sums = tc.trim_conv2d_weight_grad(x, gy, **kw_)
    again = tc.trim_conv2d_weight_grad(x, gy, **kw_)
    assert tc.LAUNCHES["wgrad_bf16"] == before["wgrad_bf16"] + 2
    assert tc.LAUNCHES["wgrad"] == before["wgrad"]
    wide = tc.trim_conv2d_weight_grad(x.float(), gy.float(), **kw_)
    torch.cuda.synchronize()
    plan = WeightGradPlan.build((n, h, w, cin), (kh, kw, cin // g, cout),
                                stride=s, pad=pads, groups=g,
                                tile_go=tile_go, dtype_bytes=2)
    assert sums.dtype == torch.float32
    if plan.route == "mma":
        assert _wgrad_f64_excess(sums, x, gy, plan) <= 0
    else:
        assert torch.equal(sums, wide)
    assert torch.equal(sums, again)
    plain = tc.trim_conv2d_weight_grad_plain(
        x, gy, kernel_size=(kh, kw), stride=s, pad=pads, groups=g)
    assert (sums - plain).abs().max().item() <= \
        TOL * plain.abs().max().item()


def _bf16_ulps(a, b) -> float:
    """max |a - b| in bf16 ulps at max(|a|, |b|) (of the normal range)."""
    a, b = a.double(), b.double()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return ((a - b).abs() / torch.pow(2.0, torch.floor(torch.log2(m)) - 7)
            ).max().item()


def test_bf16_cnn_train_step_on_the_kernels_matches_plain(cuda, monkeypatch):
    """One bf16 ``train_step`` of the example CNN on the kernels: the
    same step again gives the same bits; against the same step with
    ``kernels.ops``' three wrappers swapped for their plain versions (the
    fmaf chain), on the card, each gradient and parameter leaf lies at
    most twice as far from the f32 step on the same draws as the plain
    step does, plus one bf16 ulp of the leaf's max (``down1``, Cin 16,
    runs on the bf16 tensor cores, whose sums the fmaf chain does not
    repeat bit for bit, so no leaf downstream of it is bitwise the plain
    step's; the plain step's own distance is the bf16 noise)."""
    from repro_torch.launch import train_cnn
    from repro_torch.models import layers
    from repro_torch.models.base import init_params
    from repro_torch.optim import adamw
    params = init_params(
        layers.simple_cnn_params(cin=3, channels=(8, 16), n_classes=10),
        torch.Generator().manual_seed(0), device=cuda, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((4, 32, 32, 3), generator=gen,
                    device=cuda).bfloat16()
    y = torch.randint(0, 10, (4,), generator=gen, device=cuda)
    names = [f"{k}.{n}" for k in sorted(params) for n in sorted(params[k])]

    def step(params, x):
        live = [t.detach().requires_grad_()
                for t in adamw.tree_leaves(params)]
        loss = train_cnn.nll_loss(layers.simple_cnn_apply(
            adamw.tree_unflatten(params, live), x), y)
        grads = torch.autograd.grad(loss, live)
        new_p, _, _, _ = train_cnn.train_step(
            params, adamw.init_moments(params, train_cnn.OPT), 0, x, y,
            apply_fn=layers.simple_cnn_apply, cfg=train_cnn.OPT)
        torch.cuda.synchronize()
        return [loss, *grads], adamw.tree_leaves(new_p)

    tc.reset_launch_counts()
    g_k, p_k = step(params, x)
    # five convs: 5 forwards + 4 input gradients (the image needs none)
    # and 5 weight gradients, twice (the gradients, then the step)
    assert tc.LAUNCHES["carry_bf16"] == 18 and tc.LAUNCHES["wgrad_bf16"] == 10
    assert tc.LAUNCHES["carry"] == tc.LAUNCHES["wgrad"] == 0
    again = step(params, x)
    assert all(torch.equal(a, b) for a, b in zip(g_k + p_k, sum(again, [])))
    p32 = {k: {n: t.float() for n, t in v.items()} for k, v in
           params.items()}
    g_32, p_32 = step(p32, x.float())
    for name, fn in tc.plain_versions().items():
        monkeypatch.setattr(ops, name, fn)
    tc.reset_launch_counts()
    g_p, p_p = step(params, x)
    assert not any(tc.LAUNCHES.values())

    def dist(a, b):
        return (a.float() - b).abs().max().item() / max(
            b.abs().max().item(), 2.0 ** -126)
    for name, a, b, f in zip(["loss", *names, *names], g_k + p_k,
                             g_p + p_p, g_32 + p_32):
        assert a.dtype == (torch.float32 if name == "loss"
                           else torch.bfloat16), name
        assert dist(a, f) <= 2 * dist(b, f) + 2.0 ** -8, name


# ---------------------------------------------------------------------------
# The bf16 tensor-core route (route mma: csrc/bf16_mma.cuh's k-order)
# ---------------------------------------------------------------------------

def _sass_functions(lib_name) -> dict:
    """{kernel instance: its SASS} of one built library (cuobjdump)."""
    import shutil
    import subprocess
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.library(lib_name)._name],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return {f: "\n".join(v) for f, v in out.items()}


def test_bf16_mma_instances_issue_hmma(cuda):
    """Every instance of the per-layer mma kernel and the fused kernel's
    bf16 instance issue ``HMMA.16816.F32.BF16``; the bf16 ffma instances
    and every f32 instance issue no HMMA."""
    conv = _sass_functions("trim_conv2d")
    fused = _sass_functions("trim_conv2d_fused")
    mma = [f for f in conv if "trim_conv2d_mma_kernel" in f]
    ffma = [f for f in conv if "trim_conv2d_kernelI" in f]
    assert len(mma) == 3 and len(ffma) == 8
    for f in mma:
        assert "HMMA.16816.F32.BF16" in conv[f], f
    for f in ffma:
        assert "HMMA" not in conv[f], f
    bf = [f for f in fused if "kernelI13__nv_bfloat16" in f]
    f32 = [f for f in fused if "kernelIfE" in f]
    assert len(bf) == len(f32) == 1
    assert "HMMA.16816.F32.BF16" in fused[bf[0]]
    assert "HMMA" not in fused[f32[0]]


def test_flash_bwd_bf16_instances_issue_hmma(cuda):
    """The flash backward's bf16 dQ (three Dp) and dK/dV (three Dp, f32
    partials and bf16 outputs) instances issue ``HMMA.16816.F32.BF16``
    and no TF32 HMMA; its f32 instances TF32 HMMA and no bf16 HMMA; the
    partials' sums no HMMA."""
    bwd = _sass_functions("flash_attention_bwd")
    bf = [f for f in bwd if "_kernelI13__nv_bfloat16" in f
          and "sum_kernel" not in f]
    f32 = [f for f in bwd if "_kernelIf" in f and "sum_kernel" not in f]
    assert len(bf) == 9 and len(f32) == 6
    for f in bf:
        assert "HMMA.16816.F32.BF16" in bwd[f] and "TF32" not in bwd[f], f
    for f in f32:
        assert "TF32" in bwd[f] and "F32.BF16" not in bwd[f], f
    for f in bwd:
        if "sum_kernel" in f:
            assert "HMMA" not in bwd[f], f


def test_bf16_wgrad_and_flash_instances_issue_hmma(cuda):
    """The weight gradient's route-mma instances (64 and 128 columns) and
    the flash kernel's three bf16 narrow instances issue
    ``HMMA.16816.F32.BF16``, the latter no TF32 HMMA; the wgrad's other
    instances and the flash kernel's f32 and wide instances no bf16
    HMMA."""
    wgrad = _sass_functions("trim_conv2d_wgrad")
    flash = _sass_functions("flash_attention")
    mma = [f for f in wgrad if "wgrad_mma_kernel" in f]
    assert len(mma) == 2
    for f in wgrad:
        assert ("HMMA.16816.F32.BF16" in wgrad[f]) == (f in mma), f
    narrow = [f for f in flash if "flash_attention_kernelI13__nv_bfloat16"
              in f]
    assert len(narrow) == 3
    for f in flash:
        assert ("HMMA.16816.F32.BF16" in flash[f]) == (f in narrow), f
    for f in narrow:
        assert "TF32" not in flash[f], f


def test_bf16_launchers_refuse_a_route_that_is_not_the_layers(cuda):
    """The plan's route goes to the launcher, which checks it against
    Cin/g: route ffma for a Cin 16 layer, or mma for Cin 8, is refused
    (cudaErrorInvalidValue), and so is an mma plan's route on the fused
    entry."""
    import ctypes
    from repro_torch.core.conv_plan import BF16_ROUTES, ConvPlan
    from repro_torch.kernels import build
    from repro_torch.kernels import trim_conv2d_fused as tfu
    lib = build.library("trim_conv2d")
    for cin in (16, 8):
        x = torch.zeros((1, 8, 8, cin), device=cuda).bfloat16()
        w = torch.zeros((3, 3, cin, 16), device=cuda).bfloat16()
        y = torch.empty((1, 8, 8, 16), device=cuda).bfloat16()
        p = ConvPlan.build(x.shape, w.shape, pad=1, dtype_bytes=2)
        wrong = 1 - BF16_ROUTES.index(p.bf16_route)
        err = lib.trim_conv2d_carry_bf16(
            x.data_ptr(), w.data_ptr(), None, y.data_ptr(), p.n, p.h, p.w,
            p.cin, p.cout, p.kh, p.kw, p.stride, 1, 1, 1, p.h_out, p.w_out,
            p.th_out, p.tile_w, p.tile_cout, p.strips_per_segment,
            p.ring_rows, p.cin_stride, 0, wrong, 1 if wrong else 0,
            1 if wrong else 0, None)
        assert err != 0, cin
    from repro_torch.core.fuse_plan import build_group
    from repro_torch.core.model import ConvLayer
    topo = [ConvLayer("a", 8, 16, 16, 3, padding=1),
            ConvLayer("b", 8, 16, 16, 3, padding=1)]
    g = build_group(topo, 0, n=1, strip_rows=4, dtype_bytes=2)
    x = torch.zeros((1, 8, 8, 16), device=cuda).bfloat16()
    ws = [torch.zeros((3, 3, 16, 16), device=cuda).bfloat16()] * 2
    y = torch.empty(g.out_shape, device=cuda).bfloat16()
    ptrs = [ws[0].data_ptr(), None, ws[1].data_ptr(), None]
    geom = tfu.kernel_geometry(g)
    err = build.library("trim_conv2d_fused").trim_conv2d_fused_bf16(
        x.data_ptr(), y.data_ptr(), (ctypes.c_void_p * 4)(*ptrs),
        (ctypes.c_int * len(geom))(*geom), (ctypes.c_int * 2)(0, 0), 1,
        None)
    assert err != 0


# VGG-16's and AlexNet's mma geometries at full channel width (smaller
# images), a rectangular sub-kernel at Cin 16 and a 1x1 / 2: (n, h, cin,
# cout, kh, kw, stride, padding)
BF16_MMA_CASES = [
    (2, 56, 64, 128, 3, 3, 1, "same"),
    (1, 28, 256, 512, 3, 3, 1, "same"),
    (2, 14, 512, 512, 3, 3, 1, "same"),
    (2, 27, 96, 256, 5, 5, 1, "same"),
    (2, 13, 384, 384, 3, 3, 1, "same"),
    (2, 23, 16, 48, 3, 2, 1, "valid"),
    (2, 28, 64, 128, 1, 1, 2, "valid"),
]


@pytest.mark.parametrize("case", BF16_MMA_CASES,
                         ids=[str(i) for i in range(len(BF16_MMA_CASES))])
def test_bf16_mma_carry_halo_batch_and_f64(cuda, case):
    """The mma route at the networks' channel widths: carry == halo, a
    row alone and a repeat bitwise, within the float64 oracle's bound;
    its input gradient (the same kernel on the dilated cotangent) carry ==
    halo and within its bound too."""
    n, h, cin, cout, kh, kw, s, padding = case
    gen = torch.Generator(device="cuda").manual_seed(h + cin + cout)
    x = torch.randn((n, h, h, cin), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((kh, kw, cin, cout), generator=gen, device=cuda)
         * (kh * kw * cin) ** -0.5).bfloat16()
    b = (0.1 * torch.randn((cout,), generator=gen, device=cuda)).bfloat16()
    pad = ((conv_pads(h, h, kh, s, padding)[0],
            conv_pads(h, h, kw, s, padding)[1]))
    kw_ = dict(stride=s, pad=pad, activation="relu")
    out = {df: tc.trim_conv2d(x, w, b, dataflow=df, **kw_)
           for df in ("carry", "halo")}
    again = tc.trim_conv2d(x, w, b, **kw_)
    one = tc.trim_conv2d(x[-1:].contiguous(), w, b, **kw_)
    torch.cuda.synchronize()
    assert torch.equal(out["carry"], out["halo"])
    assert torch.equal(out["carry"], again)
    assert torch.equal(out["carry"][-1:], one)
    assert _bf16_f64_excess(out["carry"], x, w, b, stride=s, pad=pad,
                            groups=1, act="relu") <= 0
    gy = torch.randn(out["carry"].shape, generator=gen,
                     device=cuda).bfloat16()
    dx = {df: tc.trim_conv2d_input_grad(gy, w, x_shape=tuple(x.shape),
                                        stride=s, pad=pad, dataflow=df)
          for df in ("carry", "halo")}
    torch.cuda.synchronize()
    assert torch.equal(dx["carry"], dx["halo"])
    gd, wt, pads = tc._input_grad_layout(gy, w, tuple(x.shape), s, pad, 1)
    assert _bf16_f64_excess(dx["carry"], gd, wt, None, stride=1, pad=pads,
                            groups=1, act=None) <= 0


def test_bf16_mma_network_served_rows_equal_forward_one(cuda):
    """A bf16 network whose convs past the first run on the tensor cores
    (Cin 16, 32), served per layer and fused: every row bitwise
    ``forward_one``'s, per layer == fused, launching only bf16 entries."""
    from repro_torch.core.model import ConvLayer
    from repro_torch.core.serving import ServingEngine, replay
    from repro_torch.models import layers
    topo = [ConvLayer("a", 16, 3, 16, 3, padding=1),
            ConvLayer("b", 16, 16, 32, 3, padding=1),
            ConvLayer("c", 8, 32, 32, 3, padding=1),
            ConvLayer("d", 8, 32, 48, 3, padding=1)]
    model = layers.TrimCNN.random(topo, n_classes=4, device=cuda,
                                  dtype=torch.bfloat16)
    xs = torch.randn((5, 16, 16, 3), generator=torch.Generator().manual_seed(
        9)).numpy()
    tc.reset_launch_counts()
    rows = {}
    for fused in (False, True):
        eng = ServingEngine.for_topology(topo, model, buckets=(1, 2, 4),
                                         device=cuda, fused=fused)
        served, rejected = replay(eng, [(0.0, i, x) for i, x in
                                        enumerate(xs)],
                                  service_model=lambda bucket: 1e-3)
        rows[fused] = [eng.forward_one(r) for r in xs]
        assert not rejected and sorted(served) == list(range(len(xs)))
        for i, row in served.items():
            assert (row == rows[fused][i]).all(), (fused, i)
    assert all((a == b).all() for a, b in zip(rows[False], rows[True]))
    assert tc.LAUNCHES["carry"] == tc.LAUNCHES["fused"] == 0
    assert tc.LAUNCHES["carry_bf16"] > 0
