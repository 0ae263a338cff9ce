"""The flash backward's geometry on the CPU.

* ``flash_attention.py``'s mirror of the backward kernels' constants (warps,
  resident rows, the streamed tile, the ring's stages, the widest head,
  the sum's threads; the shared-memory budget is conv_plan's) against the
  namespace-scope
  ``constexpr``s parsed from ``csrc/flash_attention_bwd.cu``, so the two
  cannot drift: the launchers refuse a block count their constants do not
  give, and a drift would show only on the card.
* ``bwd_plan``'s grids and partials' scratch at the LM
  training shape (t), recurrentgemma-2b's (c), a GQA group of 7, Lq < Lk,
  the SMOKE shapes and G = 1; at (t) the dK/dV grid fills the H100's 132
  SMs (PR 25's design ran 128 blocks there).
* The plain backward, whose key tile follows the dQ kernel's, changes
  only in rounding with the tile (16, 32 and 64 keys); the partials'
  plain sum adds the heads in order, and the query heads' partials, laid
  out as the plan's scratch, sum to the GQA gradient.

``test_torch_flash_grad.py::test_plain_backward_matches_jax_vjp`` holds
the plain backward at this tile against ``jax.vjp`` of JAX's ``chunked``
and ``ref``.
"""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.core.conv_plan import SMEM_PER_BLOCK
from repro_torch.kernels import flash_attention as fa

CU = (Path(fa.__file__).resolve().parent / "csrc" /
      "flash_attention_bwd.cu")


def test_plan_constants_match_the_kernel():
    found = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);",
                                 CU.read_text(), re.M):
        found[name] = eval(expr.replace("/", "//"), {"__builtins__": {}},
                           dict(found))
    assert found == {
        "kWarps": fa.BWD_WARPS,
        "kThreads": 32 * fa.BWD_WARPS,
        "kBlockRows": fa.BWD_BLOCK_ROWS,
        "kTile": fa.BWD_BLOCK_K,
        "kStages": fa.BWD_STAGES,
        "kMaxDp": fa.MAX_BWD_D,
        "kSumThreads": fa.BWD_SUM_THREADS,
        "kMaxSmemBytes": SMEM_PER_BLOCK,
        "kJ": fa.BWD_BLOCK_K // 8,
    }
    # a warp holds 16 resident rows (the M of mma.sync.m16n8k8)
    assert fa.BWD_BLOCK_ROWS == 16 * fa.BWD_WARPS


# (b, lq, lk, hq, hkv, d) -> (dp, dq blocks, dkdv blocks, sum blocks,
# scratch bytes)
PLANS = {
    "t_train": ((2, 1024, 1024, 16, 2, 128),
                (128, 512, 512, 512, 2 * 8 * 2 * 1024 * 2 * 128 * 4)),
    "c_rgemma": ((1, 4096, 4096, 10, 1, 256),
                 (256, 640, 640, 1024, 2 * 10 * 4096 * 256 * 4)),
    "g7_d64": ((2, 1024, 1024, 14, 2, 64),
               (64, 448, 448, 256, 2 * 7 * 2 * 1024 * 2 * 64 * 4)),
    "lq_lt_lk": ((2, 256, 1024, 16, 2, 128),
                 (128, 128, 512, 512, 2 * 8 * 2 * 1024 * 2 * 128 * 4)),
    "smoke": ((8, 64, 64, 4, 2, 16),
              (64, 32, 32, 16, 2 * 2 * 8 * 64 * 2 * 16 * 4)),
    "g1": ((1, 90, 90, 3, 3, 32), (64, 6, 6, 0, 0)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_grids_and_scratch(name):
    shape, want = PLANS[name]
    plan = fa.bwd_plan(*shape)
    assert (plan.dp, plan.dq_blocks, plan.dkdv_blocks, plan.sum_blocks,
            plan.scratch_bytes) == want
    b, lq, lk, hq, hkv, d = shape
    assert plan.group == hq // hkv
    assert plan.scratch == ((2, plan.group, b, lk, hkv, d)
                            if plan.group > 1 else ())
    # every row, key and gradient element has a block
    assert plan.dq_blocks * fa.BWD_BLOCK_ROWS >= b * hkv * lq * plan.group
    assert plan.dkdv_blocks * fa.BWD_BLOCK_ROWS >= b * hq * lk
    assert plan.sum_blocks * 4 * fa.BWD_SUM_THREADS >= (
        b * lk * hkv * d if plan.group > 1 else 0)


def test_training_shape_fills_the_card():
    plan = fa.bwd_plan(*PLANS["t_train"][0])
    assert plan.dkdv_blocks >= 132 and plan.dq_blocks >= 132


def test_wide_heads_have_no_plan():
    with pytest.raises(NotImplementedError, match="Queue 2 C item 8"):
        fa.bwd_plan(1, 8, 8, 4, 2, 264)


@pytest.mark.parametrize("case", [(2, 70, 70, 4, 2, 16, True, None, None),
                                  (1, 33, 100, 14, 2, 64, True, 5.0, 25),
                                  (1, 40, 60, 6, 3, 12, False, None, 20)])
def test_plain_backward_tile_changes_only_rounding(case):
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator().manual_seed(3)
    q, do = (torch.randn((b, lq, hq, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, lk, hkv, d), generator=gen) for _ in range(2))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    _, lse = fa._plain_forward(q, k, v, block_k=fa.BLOCK_K, **kw)
    base = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
    for block_k in (32, 64):
        for got, want in zip(fa.flash_attention_backward_plain(
                q, k, v, lse, do, block_k=block_k, **kw), base):
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item()


def test_sum_partials_plain_adds_heads_in_order():
    gen = torch.Generator().manual_seed(4)
    part = torch.randn((2, 7, 2, 40, 2, 12), generator=gen)
    dk, dv = fa.sum_partials_plain(part)
    for got, half in zip((dk, dv), part):
        want = half[0].clone()
        for i in range(1, half.shape[0]):
            want = want + half[i]
        assert torch.equal(got, want)
        torch.testing.assert_close(got, half.sum(0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", [(1, 40, 70, 8, 1, 16, True, None, None),
                                  (2, 33, 33, 14, 2, 12, True, 5.0, 20),
                                  (1, 20, 50, 4, 2, 8, False, None, None)])
def test_head_partials_sum_to_the_gqa_gradient(case):
    """The dK/dV kernel's scheme on the plain versions: each query head's
    dK and dV (the plain backward with K and V repeated per query head,
    G = 1), laid out as the plan's scratch and summed in head order, is
    the GQA gradient."""
    b, lq, lk, hq, hkv, d, causal, cap, win = case
    gen = torch.Generator().manual_seed(5)
    q, do = (torch.randn((b, lq, hq, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, lk, hkv, d), generator=gen) for _ in range(2))
    kw = dict(causal=causal, soft_cap=cap, window=win)
    plan = fa.bwd_plan(b, lq, lk, hq, hkv, d)
    g = plan.group
    _, lse = fa._plain_forward(q, k, v, block_k=fa.BLOCK_K, **kw)
    _, dk_h, dv_h = fa.flash_attention_backward_plain(
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2), lse, do,
        **kw)
    part = torch.stack([x.reshape(b, lk, hkv, g, d).permute(3, 0, 1, 2, 4)
                        for x in (dk_h, dv_h)])
    assert part.shape == plan.scratch
    _, dk, dv = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
    for got, want in zip(fa.sum_partials_plain(part), (dk, dv)):
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item()
