"""The port's CUDA conv kernels on the card, against their plain versions.

Marked ``gpu``: every test skips (inside a fixture) where PyTorch sees no
GPU.  On a GPU host, from the repository root (the repo's conftest needs
JAX, which such a host need not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_cuda.py

Small random geometries that reach every edge of the kernel: ragged
bottom and right edges, bands narrower than the output, strides above K,
grouped and depthwise convs, C_out tiles that do not divide C_out, and
each activation.  Tolerance: 1e-4 * max(1, max|plain|) (f32 sums in
another order); carry and halo must agree bitwise.  The weight-gradient
kernel is held against its plain version within 1e-4 * max|plain| and
must repeat bitwise; the input gradient (the forward kernel on the
dilated cotangent) and the autograd conv against the ``ref`` oracle.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import trim_conv2d as tc
from repro_torch.kernels.ref import conv_pads

pytestmark = pytest.mark.gpu

TOL = 1e-4


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
# chunks, chunks that cross image boundaries, row tiles that span taps
# (Cin/g < 64) or not (Cin/g = 64, 128), C_out tiles that do not divide
# C_out, a single chunk (dw written directly), depthwise and grouped.
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
