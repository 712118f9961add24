"""K7's design rule (``ishara_tpu_torch/ops/conv_kernel.py``'s
``conv_plan``, mirrored by ``csrc/conv_module.cu``'s ``ishara_conv_plan``,
which alone owns the layout; the card tests hold the two equal and the
layout within the card's shared memory) and the forward's kept ``p``:
which shapes take the ``wgmma`` design, which design each direction of a
launch reports, the alignment the kernels need, and that the plain
backward given the forward's ``p`` equals the one that rebuilds it, bit for
bit. CPU only, seconds."""

import pytest
import torch

from ishara_tpu_torch.ops import conv_kernel as ck

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,D,E,K,want", [
    # every preset trains at D 256, E 512, K 15
    (BF, 256, 512, 15, "wgmma"),
    (BF, 64, 128, 15, "wgmma"),
    (BF, 128, 256, 15, "wgmma"),
    (BF, 192, 384, 15, "wgmma"),
    (BF, 256, 256, 15, "wgmma"),
    (BF, 256, 512, 3, "wgmma"),
    (BF, 256, 512, 1, "wgmma"),
    (BF, 256, 512, 16, "wgmma"),
    # more taps than one 16-row halo, f32, widths off the 64 grid or past
    # what a warpgroup's accumulator holds: the tile kernels
    (BF, 256, 512, 17, "tile"),
    (BF, 256, 512, 33, "tile"),
    (BF, 256, 512, 63, "tile"),
    (F32, 256, 512, 15, "tile"),
    (F32, 64, 128, 3, "tile"),
    (BF, 144, 288, 15, "tile"),
    (BF, 32, 64, 15, "tile"),
    (BF, 320, 640, 15, "tile"),
    (BF, 512, 1024, 15, "tile"),
    (BF, 256, 96, 15, "tile"),
    (torch.float16, 256, 512, 15, "tile"),
])
def test_the_rule(dtype, D, E, K, want):
    assert ck.conv_plan(dtype, D, E, K) == want


@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("E", [64, 256, 512, 1024])
@pytest.mark.parametrize("K", [1, 15, 16])
def test_every_accepted_shape_takes_wgmma_both_ways(D, E, K):
    """Every width the rule accepts takes the wgmma design forward and
    backward, at any T (the design's tiles cover any length)."""
    assert ck.conv_plan(BF, D, E, K) == "wgmma"
    for T in (1, 47, 48, 176, 512):
        x = torch.zeros((1, T, D), dtype=BF)
        assert ck.design_of(x, E, K, False) == "wgmma"
        assert ck.design_of(x, E, K, True) == "wgmma"


def test_design_of_each_direction():
    x = torch.zeros((2, 40, 256), dtype=BF)
    assert ck.design_of(x, 512, 15, False) == "wgmma"
    assert ck.design_of(x, 512, 15, True) == "wgmma"
    assert ck.design_of(x, 512, 33, False) == "tile"
    # the 16-row tile's halo of 48 rows is too tall backward: general
    assert ck.design_of(x, 512, 33, True) == "general"
    x = torch.zeros((2, 40, 256), dtype=F32)
    assert ck.design_of(x, 512, 15, False) == "tile"
    x = torch.zeros((2, 40, 768), dtype=BF)
    assert ck.design_of(x, 1536, 15, False) == "general"
    assert ck.design_of(x, 1536, 15, True) == "general"


@pytest.mark.parametrize("offset,ok", [(0, True), (8, True), (1, False),
                                       (4, False), (7, False)])
def test_the_kernels_take_x_and_dy_on_16_bytes(offset, ok):
    """The kernels read x and dy in 16-byte vectors: a contiguous view whose
    storage starts off that alignment is refused before any launch."""
    t = torch.zeros(64, dtype=BF)[offset:offset + 32]
    assert t.is_contiguous()
    if ok:
        ck._check_aligned("x", t)
    else:
        with pytest.raises(ValueError, match="x on 16 bytes"):
            ck._check_aligned("x", t)


def _operands(dtype, seed=0, B=3, T=20, D=16, E=32, K=5, r=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, T, D), generator=g).to(dtype)
    mask = (torch.arange(T)[None, :]
            < torch.tensor([T, T // 2, 0])[:, None]).float()
    params = (1.0 + 0.1 * torch.randn(D, generator=g),
              0.1 * torch.randn(D, generator=g),
              torch.randn((D, E), generator=g) / D ** 0.5,
              0.1 * torch.randn(E, generator=g),
              torch.randn((K, E), generator=g) / K ** 0.5,
              torch.randn((E, D), generator=g) / E ** 0.5,
              0.1 * torch.randn(D, generator=g),
              torch.randn((D, r), generator=g) / D ** 0.5,
              0.1 * torch.randn(r, generator=g),
              torch.randn((r, D), generator=g) / r ** 0.5,
              0.1 * torch.randn(D, generator=g))
    dy = torch.randn((B, T, D), generator=g).to(dtype)
    return x, ck._prep(x, mask, *params), dy


@pytest.mark.parametrize("dtype", [F32, BF])
def test_plain_backward_given_the_forward_s_p_equals_rebuilding_it(dtype):
    x, args, dy = _operands(dtype, seed=1)
    out, p = ck.conv_module_forward_plain(x, *args, with_p=True)
    assert torch.equal(out, ck.conv_module_forward_plain(x, *args))
    assert p.dtype == F32 and p.shape == x.shape
    given = ck.conv_module_backward_plain(x, args[0], dy, *args[1:], p=p)
    rebuilt = ck.conv_module_backward_plain(x, args[0], dy, *args[1:])
    assert len(given) == len(rebuilt) == 12
    for a, b in zip(given, rebuilt):
        assert torch.equal(a, b)


def test_the_autograd_function_keeps_the_forward_s_p():
    """On the CPU the wrapper's backward takes the p its forward kept, and
    its gradients are the plain backward's; the counters by design exist
    for every design and move only on the card."""
    x, args, dy = _operands(F32, seed=2)
    mask, *params = args
    xs = x.clone().requires_grad_()
    ps = [q.clone().requires_grad_() for q in params]
    before = (dict(ck.conv_module_residual.launches_by_design),
              dict(ck.conv_module_residual.launches_bwd_by_design))
    out = ck.conv_module_residual(xs, mask, *ps)
    got = torch.autograd.grad(out, [xs] + ps, dy)
    want = ck.conv_module_backward_plain(x, mask, dy, *params)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert set(before[0]) == set(before[1]) == {"wgmma", "tile", "general"}
    assert (ck.conv_module_residual.launches_by_design,
            ck.conv_module_residual.launches_bwd_by_design) == before


def test_the_backward_keeps_x_and_p_beside_the_operands():
    """The autograd function saves x, the forward's p and the twelve
    operands, nothing more: no pool partials or other forward state."""
    x, args, _ = _operands(BF, seed=3)
    mask, *params = args
    out = ck.conv_module_residual(x.clone().requires_grad_(), mask,
                                  *(q.clone().requires_grad_()
                                    for q in params))
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 14
    assert saved[1].dtype == F32 and saved[1].shape == x.shape
    assert torch.equal(saved[1], ck.conv_module_forward_plain(
        x, *args, with_p=True)[1])
