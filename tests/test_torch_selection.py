"""The port's kernel-versus-composition table (``ishara_tpu_torch/ops/
selection.py``): which row each geometry the port drives resolves to, and
the reference's rule that the tiled attention kernel, which has no dropout
inside, gives way to the row's dropout choice when dropout is active
(``ishara_tpu/ops/selection.py``'s ``train_attention``, checked here against
the reference function on the port's table)."""

import pytest

from ishara_tpu.ops import selection as jsel

from ishara_tpu_torch.ops import selection

FLAGSHIP = (256, 176, 256)
LONG = (256, 512, 256)


def test_the_flagship_step_and_serving_keep_the_flagship_row():
    flagship = selection._ANCHORS[FLAGSHIP]
    assert selection._nearest(*FLAGSHIP) is flagship
    assert selection._nearest(256, 176, 1) is flagship      # batch-1 serving
    assert selection._nearest(256, 176) is flagship         # default batch
    assert selection.train_attention(256, 176, True, 256) == "flash"
    assert selection.train_attention(256, 176, False, 256) == "flash"
    assert selection.ffn_fused_when_dropout(256, 176, 256)
    assert selection.conv_module_fused(256, 176, 256)
    assert selection.serve_attention(256, 176) == "einsum"


def test_the_long_sequence_step_resolves_to_the_long_row():
    assert selection._nearest(*LONG) is selection._ANCHORS[LONG]
    assert selection.train_attention(256, 512, False, 256) == "flash_blocked"
    assert selection.conv_module_fused(256, 512, 256)
    assert selection.serve_attention(256, 512) == "einsum"
    # the boundary at equal dim and batch: sqrt(176 * 512) ~ 300 (both rows
    # take the conv-module kernel; the attention without dropout changes)
    assert selection.train_attention(256, 299, False, 256) == "flash"
    assert selection.train_attention(256, 301, False, 256) == "flash_blocked"
    assert selection.conv_module_fused(256, 299, 256)


@pytest.mark.parametrize("geometry", [FLAGSHIP, LONG, (64, 400, 4),
                                      (512, 1024, 32), (128, 24, 8)])
def test_dropout_active_never_selects_the_tiled_kernel(geometry, monkeypatch):
    """With dropout on, every row's dropout choice is "flash" or "einsum"
    (so beyond T = 384 the layer takes the composition); the port's
    function agrees with the reference's clamp run on the port's table."""
    dim, T, B = geometry
    got = selection.train_attention(dim, T, True, B)
    assert got in ("flash", "einsum")
    assert selection.train_attention(dim, T, True, B) \
        == selection._nearest(dim, T, B)["train_attn"]
    monkeypatch.setattr(jsel, "_ANCHORS", selection._ANCHORS)
    for active in (True, False):
        assert jsel.train_attention(dim, T, active, B) \
            == selection.train_attention(dim, T, active, B)


def test_clamp_on_a_row_whose_dropout_choice_is_einsum(monkeypatch):
    row = dict(selection._ANCHORS[LONG], train_attn="einsum",
               train_attn_nodrop="flash_blocked")
    monkeypatch.setattr(selection, "_ANCHORS", {LONG: row})
    assert selection.train_attention(256, 512, True, 256) == "einsum"
    assert selection.train_attention(256, 512, False, 256) == "flash_blocked"
    row["train_attn"] = "flash_blocked"      # as the reference: "einsum"
    assert selection.train_attention(256, 512, True, 256) == "einsum"


@pytest.mark.parametrize("geometry", [FLAGSHIP, LONG, (64, 16, 8),
                                      (144, 400, 4), (512, 1024, 32)])
def test_conv_module_kernel_is_taken_by_bf16_only(geometry):
    """The conv-module rows hold for bf16: f32 takes the composition at
    every geometry (the kernel lost to it 2.3-2.5x there, PERF.md), bf16
    reads the row, and the default dtype is bf16's."""
    import torch

    dim, T, B = geometry
    row = selection._nearest(dim, T, B)["conv_module_fused"]
    assert selection.conv_module_fused(dim, T, B, torch.bfloat16) is row
    assert selection.conv_module_fused(dim, T, B) is row
    assert selection.conv_module_fused(dim, T, B, torch.float32) is False


def test_the_layer_passes_its_dtype_and_fused_true_forces_the_kernel(
        monkeypatch):
    """The Squeezeformer conv module asks the table with ``x``'s dtype: in
    training with the kernel paths taken, f32 runs the composition under
    ``fused=None`` and the kernel under ``fused=True``; bf16 runs the
    kernel under ``fused=None`` (the flagship row)."""
    import torch

    from ishara_tpu_torch.models import layers as tlayers

    calls = []
    wrapper = tlayers.conv_kernel.conv_module_residual

    def spy(x, *a):
        calls.append(x.dtype)
        return wrapper(x, *a)

    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers.conv_kernel, "conv_module_residual", spy)
    monkeypatch.setattr(selection, "_ANCHORS",
                        {(32, 24, 2): selection._ANCHORS[FLAGSHIP]})
    for dtype, fused, want in ((torch.float32, None, []),
                               (torch.float32, True, [torch.float32]),
                               (torch.bfloat16, None, [torch.bfloat16])):
        calls.clear()
        m = tlayers.SqueezeformerConvModule(32, 3, 2, dtype=dtype,
                                            fused=fused)
        x = torch.randn((2, 24, 32)).to(dtype)
        m(x, torch.ones((2, 24), dtype=torch.bool), training=True)
        assert calls == want, (dtype, fused)
