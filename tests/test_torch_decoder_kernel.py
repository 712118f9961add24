"""K9's plain versions (``ishara_tpu_torch.ops.decoder_kernel``, the
whole-loop greedy and beam decodes a CPU tensor takes) against the JAX
package's Pallas kernels in interpret mode and its XLA loops; the guard.

Small sizes (dim 32, 4 heads, 2 decoder layers, T = 12, 30 classes,
``max_len`` 12); weights from numpy seeds, bridged. The plain versions read
the JAX encoder's memory, so both sides decode the same numbers: tokens
exactly, raw and length-normalised beam scores within 1e-5 (f32 sums in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ishara_tpu.decode import autoregressive as jar
from ishara_tpu.ops import decoder_kernel as jdk

from ishara_tpu_torch.ops import decoder_kernel as tdk

from torch_port_helpers import (
    port_translation_model,
    translation_models,
    with_eos_bias,
)

D, H, C, T, S = 32, 4, 30, 12, 12
KW = dict(num_classes=C, feature_dim=D, num_layers=2, num_decoder_layers=2,
          num_heads=H)


@pytest.fixture(scope="module")
def models():
    jm, v, pm, x, mask, _ = translation_models(dim=D, heads=H, classes=C,
                                               T=T, seed=3)
    return jm, v, pm, x, mask


def _case(models, mask_kind, eos_bias=None):
    """(jax model, variables, port model, x [1], mask [1] or None, memory
    from the JAX encoder as numpy)."""
    jm, v, pm, x, mask = models
    if eos_bias is not None:
        v = with_eos_bias(v, eos_bias)
        pm = port_translation_model(v, **KW)
    m = {"mask": mask[:1], "none": None,
         "all_masked": np.zeros((1, T), bool)}[mask_kind]
    x = x[:1]
    memory, _ = jm.apply(v, jnp.asarray(x),
                         None if m is None else jnp.asarray(m),
                         method=jm.encode)
    return jm, v, pm, x, m, np.asarray(memory)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mask_kind,eos_bias", [
    ("mask", None), ("none", None), ("all_masked", None), ("mask", 100.0)])
def test_greedy_plain_matches_jax(models, mask_kind, eos_bias):
    """The plain greedy decode against fused_greedy_decode (interpret) and
    greedy_translate_cached; an eos forced by the classifier bias gives
    [sos, eos, pad, ...]."""
    jm, v, pm, x, m, memory = _case(models, mask_kind, eos_bias)
    jm_mask = None if m is None else jnp.asarray(m)
    want = np.asarray(jdk.fused_greedy_decode(
        jm, v, jnp.asarray(memory), jm_mask, max_len=S, interpret=True))
    loop, _ = jar.greedy_translate_cached(jm, v, jnp.asarray(x), jm_mask,
                                          max_len=S)
    np.testing.assert_array_equal(want, np.asarray(loop))
    before = tdk.fused_greedy_decode.launches
    got = tdk.fused_greedy_decode(pm, _t(memory), _t(m), max_len=S)
    assert tdk.fused_greedy_decode.launches == before  # a CPU tensor: plain
    assert got.dtype == torch.int32 and got.shape == (1, S)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos_bias:
        assert want[0].tolist() == [1, 2] + [0] * (S - 2)


@pytest.mark.parametrize("width,penalty,mask_kind,eos_bias", [
    (1, 0.0, "mask", None), (3, 0.0, "mask", None), (3, 0.5, "mask", None),
    (3, 0.0, "all_masked", None), (3, 0.0, "mask", 2.0),
    (9, 0.0, "mask", None)])
def test_beam_plain_matches_jax(models, width, penalty, mask_kind, eos_bias):
    """The plain beam decode against fused_beam_decode (interpret): every
    beam's tokens exactly and its raw score; the best beam and its
    length-normalised score against beam_translate_cached. With the eos bias
    one beam finishes at the first step and extends with pad at cost 0
    while the others go on."""
    jm, v, pm, x, m, memory = _case(models, mask_kind, eos_bias)
    jm_mask = None if m is None else jnp.asarray(m)
    wt, ws = jdk.fused_beam_decode(jm, v, jnp.asarray(memory), jm_mask,
                                   max_len=S, beam_width=width,
                                   interpret=True)
    gt, gs = tdk.fused_beam_decode(pm, _t(memory), _t(m), max_len=S,
                                   beam_width=width)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)
    if eos_bias:
        rows = gt.numpy().tolist()
        assert [1, 2] + [0] * (S - 2) in rows and any(2 not in r for r in rows)
    lt, _, lscore = jar.beam_translate_cached(
        jm, v, jnp.asarray(x), jm_mask, max_len=S, beam_width=width,
        length_penalty=penalty)
    bt, _, bscore = tdk.fused_beam_translate(
        pm, torch.from_numpy(x), _t(m), max_len=S, beam_width=width,
        length_penalty=penalty)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(lt))
    np.testing.assert_allclose(float(bscore), float(lscore), rtol=1e-5,
                               atol=1e-5)


def test_beam_width_one_is_greedy(models):
    _, _, pm, _, m, memory = _case(models, "mask")
    greedy = tdk.fused_greedy_decode(pm, _t(memory), _t(m), max_len=S)
    beam, _ = tdk.fused_beam_decode(pm, _t(memory), _t(m), max_len=S,
                                    beam_width=1)
    assert torch.equal(greedy, beam)


def test_fused_translate_matches_cached_loops(models):
    """fused_greedy_translate / fused_beam_translate from raw x: encoder,
    then the decode, as the port's own KV-cached loops."""
    from ishara_tpu_torch.decode import autoregressive as tar

    _, _, pm, x, mask = models
    xt, mt = torch.from_numpy(x[:1]), torch.from_numpy(mask[:1])
    got, conf = tdk.fused_greedy_translate(pm, xt, mt, max_len=S)
    want, wconf = tar.greedy_translate_cached(pm, xt, mt, max_len=S)
    assert torch.equal(got, want) and torch.equal(conf, wconf)
    got, _, score = tdk.fused_beam_translate(pm, xt, mt, max_len=S,
                                             beam_width=3)
    want, _, wscore = tar.beam_translate_cached(pm, xt, mt, max_len=S,
                                                beam_width=3)
    assert torch.equal(got, want)
    np.testing.assert_allclose(float(score), float(wscore), rtol=1e-5)


def test_memory_add_and_pack(models):
    """The additive mask is 0 / -1e30; the pack holds every decoder leaf
    once, in the kernel's order."""
    _, _, pm, _, mask = models
    add = tdk.memory_add(torch.from_numpy(mask[:1]), T, "cpu")
    assert torch.equal(add, torch.tensor([0.0] * (T - 3) + [tdk.NEG] * 3))
    pack = tdk.pack_decoder(pm)
    n = sum(p.numel() for name, p in pm.named_parameters()
            if name.startswith(("decoder_layers", "decoder_norm",
                                "classifier", "target_embedding"))
            and ".ca_k." not in name and ".ca_v." not in name)
    assert pack.numel() == n == tdk.pack_floats(D, 2, C)
    layers, tail = tdk._views(pack, D, 2, C)
    assert torch.equal(layers[1]["w1"], pm.decoder_layers[1].fc1.weight)
    assert torch.equal(tail["embed"], pm.target_embedding.embedding)
    with pytest.raises(ValueError, match="pack"):
        tdk.fused_greedy_decode(pm, torch.zeros((1, T, D)), pack=pack[:-1])


@pytest.mark.parametrize("geometry,fits", [
    (dict(T=12, max_len=12, beam_width=3), True),
    (dict(T=12, max_len=12, beam_width=C + 1), False),      # W > C
    (dict(T=12, max_len=12, beam_width=C), True),           # W = C
    (dict(T=70000, max_len=12, beam_width=1), False),        # shared memory
    (dict(T=12, max_len=1, beam_width=1), False),
])
def test_guard(models, geometry, fits):
    """fused_decode_fits answers from the kernel's own limits, and the
    wrappers raise beyond them -- no fallback to the unfused loop."""
    _, _, pm, _, _ = models
    assert tdk.fused_decode_fits(pm, **geometry) is fits
    if fits:
        return
    memory = torch.zeros((1, geometry["T"], D))
    with pytest.raises(tdk.DecoderFitError):
        tdk.fused_beam_decode(pm, memory, max_len=geometry["max_len"],
                              beam_width=geometry["beam_width"])


def test_guard_at_the_reference_geometry():
    """The translation flagship (dim 208, 8 heads, 2 + 2 layers, 62
    classes, T 176, max_out 64) fits greedy and at beam width 4 with the
    caches and the cross-attention K / V in shared memory, each head's
    columns split over two blocks (4 score exchanges a step), 7 stage
    exchanges (the cluster's synchronisations) a step, and the weights a
    block cannot keep streamed through the ring; dim 208 with 7 heads does
    not fit (208 / 7 is no whole head)."""
    from ishara_tpu_torch.models.seq2seq import ASLTranslationModel

    m = ASLTranslationModel()
    want = {1: (54080, 252096), 4: (35776, 270400)}
    for w in (1, 4):
        assert tdk.fused_decode_fits(m, 176, 64, w)
        plan = tdk.decode_plan(208, 8, 2, 62, 176, 64, w)
        assert plan["cluster"] == 16 and plan["barriers_per_step"] == 7
        assert plan["parts"] == 2 and plan["score_exchanges_per_step"] == 4
        assert plan["cache_smem"] and plan["cross_smem"] and plan["slots"]
        assert plan["smem_bytes"] <= tdk.SMEM_PER_BLOCK
        assert (plan["resident_bytes"], plan["streamed_bytes"]) == want[w]
    m.num_heads = 7
    assert not tdk.fused_decode_fits(m, 176, 64, 1)


@pytest.mark.parametrize("geometry", [
    (208, 8, 2, 62, 176, 64, 1), (208, 8, 2, 62, 176, 18, 1),
    (208, 8, 2, 62, 176, 64, 4), (208, 8, 2, 62, 176, 64, 12),
    (320, 2, 2, 62, 176, 64, 1), (32, 4, 2, 30, 12, 12, 3),
    (64, 16, 3, 10, 40, 8, 8)])
@pytest.mark.parametrize("cluster", [16, 8])
def test_decode_plan(geometry, cluster):
    """decode_plan (the kernel's division of the work, csrc/decoder.cu
    make_plan): every column of every (layer, head) and every FFN and
    classifier row belongs to exactly one block, each unit and row range
    in that block's pieces; a head's columns are split over cluster // H
    blocks where the cluster has at least twice as many blocks as heads,
    so that every block takes part in each attention stage; 3 L + 1
    barriers a step; a block's resident and streamed bytes add up to its
    pieces, and all blocks' to the pack's product weights (the pack less
    its vectors and the embedding); the layout fits."""
    d, H, L, C, T, S, W = geometry
    plan = tdk.decode_plan(*geometry, cluster=cluster)
    assert plan is not None and plan["cluster"] == cluster
    assert plan["barriers_per_step"] == 3 * L + 1
    Dh = d // H
    parts = min(cluster // H, Dh) if cluster >= 2 * H else 1
    assert plan["parts"] == parts
    assert (plan["score_exchanges_per_step"] > 0) == (parts > 1)
    blocks = plan["blocks"]
    assert len(blocks) == cluster
    cols = sorted((l, h, c) for b in blocks for l, h, c0, nc in b["units"]
                  for c in range(c0, c0 + nc))
    assert cols == [(l, h, c) for l in range(L) for h in range(H)
                    for c in range(Dh)]
    if parts > 1:   # every block with a unit has one of every layer
        busy = [b for b in blocks if b["units"]]
        assert len(busy) == H * parts
        assert all(sorted(u[0] for u in b["units"]) == list(range(L))
                   for b in busy)
    for key, n in (("ffn_rows", 4 * d), ("classifier_rows", C)):
        ranges = [b[key] for b in blocks]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    total = 0
    for b in blocks:
        kinds = [p[0] for p in b["pieces"]]
        assert kinds.count("qkv") == kinds.count("cross_q") == len(b["units"])
        mine = sum(p[2] * p[3] for p in b["pieces"])
        assert mine == (sum(6 * nc * d for _, _, _, nc in b["units"])
                        + 2 * L * d * (b["ffn_rows"][1] - b["ffn_rows"][0])
                        + d * (b["classifier_rows"][1]
                               - b["classifier_rows"][0]))
        assert b["resident_bytes"] + b["streamed_bytes"] == 4 * mine
        assert 4 * b["smem_words"] <= tdk.SMEM_PER_BLOCK
        total += mine
    vectors = L * 17 * d + 2 * d + C
    assert total == tdk.pack_floats(d, L, C) - vectors - C * d
    assert plan["smem_bytes"] >= plan["fixed_bytes"]


@pytest.mark.parametrize("geometry", [
    dict(T=176, max_len=64, beam_width=9),
    dict(T=176, max_len=64, beam_width=12),
    dict(T=176, max_len=64, beam_width=8),
    dict(T=176, max_len=18, beam_width=1),
    dict(T=384, max_len=64, beam_width=4),
])
def test_guard_takes_the_lifted_limits(geometry):
    """Beams above 8 (in passes of 4) and the reference geometry's caches
    in global memory where shared memory cannot hold them (beams 8, 9
    and 12): the guard takes them; so does a head of 160 (dim 320, 2
    heads)."""
    from ishara_tpu_torch.models.seq2seq import ASLTranslationModel

    m = ASLTranslationModel()
    assert tdk.fused_decode_fits(m, **geometry)
    wide = ASLTranslationModel(feature_dim=320, num_heads=2)
    assert tdk.fused_decode_fits(wide, **geometry)
    plan = tdk.decode_plan(208, 8, 2, 62, geometry["T"],
                           geometry["max_len"], geometry["beam_width"])
    assert plan is not None
    if geometry["beam_width"] >= 8:
        assert not plan["cache_smem"] and plan["scratch_floats"] > 0


@pytest.mark.parametrize("geometry", [
    (32, 4, 1, 30, 12, 12, 31),      # W > C
    (32, 4, 1, 30, 12, 1, 1),        # S < 2
    (32, 5, 1, 30, 12, 12, 1),       # no whole head
    (32, 4, 1, 30, 70000, 12, 1),    # shared memory
])
def test_guard_still_refuses(geometry):
    assert tdk._limits(*geometry) is not None


@pytest.mark.parametrize("geometry", [
    (208, 8, 2, 62, 176, 64, 1), (208, 8, 2, 62, 176, 64, 4),
    (208, 8, 2, 62, 176, 64, 8), (32, 4, 2, 30, 12, 12, 3),
    (64, 2, 3, 10, 40, 8, 8), (128, 1, 2, 62, 2000, 64, 8),
    (256, 2, 4, 62, 1000, 64, 1)])
def test_guard_takes_what_the_first_kernel_took(geometry):
    """Geometries the first design's guard took (every W <= 8, heads up to
    128, its shared-memory formula) still fit."""
    assert tdk._limits(*geometry) is None


def test_other_devices_are_refused(models):
    _, _, pm, _, _ = models
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tdk.fused_greedy_decode(pm, torch.zeros((1, T, D), device="meta"),
                                max_len=S)
