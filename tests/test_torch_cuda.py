"""The port's CUDA conv kernels on the card, against their plain version.

Marked ``gpu``: every test skips (inside a fixture) where PyTorch sees no
GPU.  On a GPU host, from the repository root (the repo's conftest needs
JAX, which such a host need not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_cuda.py

Small random geometries that reach every edge of the kernel: ragged
bottom and right edges, bands narrower than the output, strides above K,
grouped and depthwise convs, C_out tiles that do not divide C_out, and
each activation.  Tolerance: 1e-4 * max(1, max|plain|) (f32 sums in
another order); carry and halo must agree bitwise.
"""

import pytest
import torch

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
