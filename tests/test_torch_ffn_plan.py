"""``ffn_plan`` of the port's feed-forward kernel K4
(``ishara_tpu_torch/ops/ffn_kernel.py``): which of ``csrc/ffn.cu``'s designs
takes a shape, as a rule on (dtype, K, M) alone, with the shared memory and
the registers it asks for. The C rule it mirrors is held to it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import pytest
import torch

from ishara_tpu_torch.ops import ffn_kernel as fk

SMEM_LIMIT = 227 * 1024   # shared memory a block can use on the H100
REG_LIMIT = 255           # registers a thread can hold

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,k,m,design", [
    # the flagship (baseline_config(4): dim 256, hidden 512)
    (BF16, 256, 512, "wgmma"),
    # K 128 / 256 with hidden widths 128 to 1024
    (BF16, 128, 128, "wgmma"), (BF16, 128, 256, "wgmma"),
    (BF16, 128, 512, "wgmma"), (BF16, 128, 1024, "wgmma"),
    (BF16, 256, 128, "wgmma"), (BF16, 256, 256, "wgmma"),
    (BF16, 256, 768, "wgmma"), (BF16, 256, 1024, "wgmma"),
    # the card tests' other shapes
    (BF16, 64, 128, "wgmma"), (BF16, 192, 512, "wgmma"),
    (BF16, 70, 100, "general"), (BF16, 384, 384, "general"),
    (BF16, 768, 256, "general"), (BF16, 384, 768, "general"),
    (F32, 128, 256, "general"), (F32, 256, 512, "general"),
    (F32, 20, 36, "general"),
    # off-grid widths
    (BF16, 20, 36, "general"), (BF16, 36, 20, "general"),
    (BF16, 100, 70, "general"), (BF16, 256, 100, "general"),
    (BF16, 320, 512, "general"), (BF16, 512, 512, "general"),
    (BF16, 384, 256, "general"), (BF16, 512, 128, "general"),
    # a tensor-parallel rank's slice of a hidden of 512 or 1024
    (BF16, 256, 256, "wgmma"), (BF16, 256, 128, "wgmma"),
    (BF16, 128, 64, "wgmma"), (BF16, 256, 96, "general"),
])
def test_ffn_plan_takes_each_shape_by_the_rule(dtype, k, m, design):
    plan = fk.ffn_plan(dtype, k, m)
    assert plan.design == design
    assert plan.fwd_smem <= SMEM_LIMIT and plan.bwd_smem <= SMEM_LIMIT
    assert plan.tile_rows % plan.part_rows == 0
    if design == "wgmma":
        # no padding: TMA reads the rows past N as zeros
        assert (plan.pad_rows, plan.tile_rows, plan.part_rows) == (1, 128, 16)
        # the forward holds 4 weight slots at once, the backward 3
        assert plan.fwd_slots >= 4 and plan.bwd_slots >= 3
        # the accumulators fit what setmaxnreg gives a consumer thread (the
        # card tests hold both to the C plan, and ptxas's report to no
        # spills)
        assert 0 < plan.acc_regs <= plan.reg_limit <= REG_LIMIT
        # partial db rows: 8 a 128-row tile, added in two passes of 8
        assert plan.parts(45056) == 352 * 8
        assert plan.parts(100) == 8
    else:
        assert plan.pad_rows == 64 and plan.acc_regs == plan.reg_limit == 0
        assert plan.parts(128) == 128 // plan.part_rows


def test_ffn_plan_is_a_rule_on_the_shape_alone():
    """The same plan for every call, and the wgmma design exactly where its
    accumulators and tiles fit: bf16, K a multiple of 64 up to 256, M a
    multiple of 64."""
    for k in range(16, 1025, 16):
        for m in range(16, 1025, 16):
            plan = fk.ffn_plan(BF16, k, m)
            assert plan == fk.ffn_plan(BF16, k, m)
            fits = k % 64 == 0 and k <= 256 and m % 64 == 0
            assert (plan.design == "wgmma") == fits, (k, m)
            assert fk.ffn_plan(F32, k, m).design == "general"


def test_wrapper_counts_launches_by_design_and_pads_by_the_plan():
    assert set(fk.ffn_residual.launches_by_design) == set(fk.DESIGNS)
    assert set(fk.ffn_residual.launches_bwd_by_design) == set(fk.DESIGNS)
    # a CPU tensor runs the plain version: no launch of any design
    before = (dict(fk.ffn_residual.launches_by_design),
              dict(fk.ffn_residual.launches_bwd_by_design))
    x = torch.randn(5, 64, requires_grad=True)
    out = fk.ffn_residual(x, x, torch.randn(64, 64), torch.zeros(64),
                          torch.randn(64, 64), torch.zeros(64),
                          torch.zeros(2, dtype=torch.int32), 0.0, 0.0)
    out.sum().backward()
    assert (fk.ffn_residual.launches_by_design,
            fk.ffn_residual.launches_bwd_by_design) == before


@pytest.mark.parametrize("dtype,p,q,design", [
    (torch.bfloat16, 256, 512, "wgmma"), (torch.bfloat16, 512, 256, "wgmma"),
    (torch.bfloat16, 8, 136, "wgmma"), (torch.bfloat16, 36, 20, "general"),
    (torch.bfloat16, 256, 12, "general"), (torch.float32, 256, 512,
                                            "general")])
def test_weight_product_design_by_the_rule(dtype, p, q, design):
    """The weight product (``csrc/wgrad.cuh``) runs on wgmma exactly at bf16
    with rows of 16-byte multiples (p and q multiples of 8), the general f32
    kernel otherwise; its plain version on a CPU tensor is the f32 matmul of
    the widened operands, and it launches nothing there."""
    assert fk.product_design(dtype, p, q) == design
    g = torch.Generator().manual_seed(p + q)
    a = torch.randn((70, p), generator=g).to(dtype)
    b = torch.randn((70, q), generator=g).to(dtype)
    before = dict(fk.weight_product.launches_by_design)
    got = fk.weight_product(a, b)
    assert got.dtype == torch.float32 and got.shape == (p, q)
    assert torch.equal(got, a.float().T @ b.float())
    assert fk.weight_product.launches_by_design == before
    with pytest.raises(ValueError, match="rows"):
        fk.weight_product(a, b[:-1])
