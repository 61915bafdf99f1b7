"""The port's EfficientNets and tiny backbone (boosted_detr_torch/models/
backbone.py: ``MBConvBlock``, ``EfficientNetLiteBackbone``, ``SEBlock``,
``MBConvSEBlock``, ``_round_filters``, ``_round_repeats``,
``EfficientNetBackbone``, ``TinyBackbone`` and ``EncoderBackbone``'s
dispatch) against the JAX package's, on the CPU, at tiny widths, float32,
``train=False`` unless a test says otherwise. Weights are drawn on the Flax
tree's shapes as in tests/test_torch_norms.py; JAX applies under
``jax.jit``. Small DETRs on these backbones: tests/test_torch_effnet_detr.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosted_detr_torch.models import backbone as tb
from boosted_detr_tpu.models import backbone as jb
from test_torch_norms import F32, _image, _np, pair

torch.set_num_threads(2)


def test_round_filters_and_repeats_on_the_keras_table():
    # keras B4's stage widths and repeats (tests/test_efficientnet_b4.py)
    base = (32, 16, 24, 40, 80, 112, 192, 320, 1280)
    assert [tb._round_filters(f, 1.4) for f in base] == \
        [48, 24, 32, 56, 112, 160, 272, 448, 1792]
    assert [tb._round_repeats(r, 1.8) for r in (1, 2, 3, 4)] == [2, 4, 6, 8]
    for width in (0.35, 0.7, 1.0, 1.1, 1.4, 2.0):
        for f in base + (8,):
            assert tb._round_filters(f, width) == jb._round_filters(f, width)
    for depth in (1.0, 1.2, 1.8, 3.1):
        for r in (1, 2, 3, 4):
            assert tb._round_repeats(r, depth) == jb._round_repeats(r, depth)


# (input width, features, expand, kernel, stride): expand 1 with the
# residual, a strided 5x5, and a residual 3x3
BLOCKS = ((16, 16, 1, 3, 1), (16, 24, 6, 5, 2), (24, 24, 6, 3, 1))


@pytest.mark.parametrize("cin, feats, expand, kernel, stride", BLOCKS)
def test_mbconv_block_matches_jax(cin, feats, expand, kernel, stride):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    ref, ours = pair(
        jb.MBConvBlock(feats, expand, (kernel, kernel), (stride, stride),
                       dtype=jnp.float32),
        tb.MBConvBlock(cin, feats, expand, kernel, stride,
                       dtype=torch.float32), rng, x)
    assert ours.depthwise.conv.weight.shape == (cin * expand, 1, kernel,
                                                kernel)
    np.testing.assert_allclose(_np(ours(torch.from_numpy(x))), ref, **F32)


def test_se_block_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 24)).astype(np.float32)
    ref, ours = pair(jb.SEBlock(6, jnp.float32),
                     tb.SEBlock(24, 6, torch.float32), rng, x)
    np.testing.assert_allclose(_np(ours(torch.from_numpy(x))), ref, **F32)


@pytest.mark.parametrize("cin, feats, expand, kernel, stride", BLOCKS)
def test_mbconv_se_block_matches_jax(cin, feats, expand, kernel, stride):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    ref, ours = pair(
        jb.MBConvSEBlock(feats, expand, (kernel, kernel), (stride, stride),
                         drop_rate=0.0, dtype=jnp.float32),
        tb.MBConvSEBlock(cin, feats, expand, kernel, stride, drop_rate=0.0,
                         dtype=torch.float32), rng, x)
    # se_filters from the block's input width, not the expanded one
    assert ours.se.reduce.weight.shape[0] == max(1, int(cin * 0.25))
    np.testing.assert_allclose(_np(ours(torch.from_numpy(x))), ref, **F32)


_BACKBONES = {}


def _backbone_case(backbone, width, norm, preprocessing="scale"):
    """(port output, JAX output, port module) of ``EncoderBackbone`` at
    64x64, once per setting."""
    key = (backbone, width, norm, preprocessing)
    if key not in _BACKBONES:
        rng = np.random.default_rng(3)
        image = _image(rng)
        args = (backbone, width, norm)
        ref, ours = pair(
            jb.EncoderBackbone(*args, jnp.float32,
                               preprocessing=preprocessing),
            tb.EncoderBackbone(*args, torch.float32,
                               preprocessing=preprocessing), rng, image)
        _BACKBONES[key] = (_np(ours(torch.from_numpy(image))), ref, ours)
    return _BACKBONES[key]


@pytest.mark.parametrize("backbone, width, norm, net, channels", [
    ("efficientnet_lite", 0.25, "batchnorm", "effnet", 320),
    ("efficientnet_b4", 0.25, "batchnorm", "effnet_b4", 448),
    ("tiny", 0.25, "batchnorm", "tiny", 128),
    ("tiny", 0.25, "groupnorm", "tiny", 128),
    ("efficientnet_lite", 0.25, "skipinit", "effnet", 320)])
def test_backbone_matches_jax(backbone, width, norm, net, channels):
    out, ref, ours = _backbone_case(backbone, width, norm)
    assert ours.net_name == net and ours.out_channels == channels
    assert out.shape == ref.shape == (2, 2, 2, channels)
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("field, values", [
    ("backbone", ("efficientnet_lite", "efficientnet_b4", "tiny")),
    ("backbone_width", (0.25, 0.5)),
    ("norm", ("batchnorm", "skipinit")),
    ("preprocessing", ("scale", "imagenet"))])
def test_effnet_fields_move_the_output_as_in_jax(field, values):
    # each field the new backbones read moves the port's output as it
    # moves JAX's
    base = dict(backbone="efficientnet_lite", width=0.25, norm="batchnorm",
                preprocessing="scale")
    key = {"backbone_width": "width"}.get(field, field)
    outs = []
    for value in values:
        out, ref, _ = _backbone_case(**dict(base, **{key: value}))
        np.testing.assert_allclose(out, ref, **F32)
        outs.append((out, ref))
    for (o0, r0), (o1, r1) in zip(outs, outs[1:]):
        if o0.shape == o1.shape:
            assert np.abs(o0 - o1).max() > 1e-3
            assert np.abs(r0 - r1).max() > 1e-3
        else:
            assert r0.shape != r1.shape


def test_b4_parameter_count_is_keras_b4():
    # keras EfficientNetB4(include_top=False).count_params() less its input
    # normalisation's 7 (tests/test_efficientnet_b4.py): parameters plus
    # BatchNorm running statistics
    net = tb.EfficientNetBackbone(1.4, 1.8)
    total = sum(t.numel() for t in net.state_dict().values())
    assert total == 17_673_823 - 7
    blocks = net.block_names
    assert len(blocks) == 32
    last = {b.split("_block")[0]: b for b in blocks}
    assert {s: getattr(net, b).project.conv.weight.shape[0]
            for s, b in last.items()} == {
        "stage0": 24, "stage1": 32, "stage2": 56, "stage3": 112,
        "stage4": 160, "stage5": 272, "stage6": 448}
    assert net.stem.conv.weight.shape[0] == 48 and net.out_channels == 1792
    assert net.stage1_block0.se.reduce.weight.shape[:2] == (6, 144)
    # stochastic depth 0.2 * k / 32 for block k
    rates = [getattr(net, b).drop_rate for b in blocks]
    np.testing.assert_allclose(rates, 0.2 * np.arange(32) / 32)


def test_stochastic_depth_keeps_or_drops_each_sample_whole():
    # GroupNorm, so that the block computes the same in train and eval
    # mode but for the drop: each sample's branch is exactly 0 or scaled
    # by 1 / keep
    block = tb.MBConvSEBlock(16, 16, 6, 3, 1, drop_rate=0.5,
                             norm="groupnorm", dtype=torch.float32)
    x = torch.randn(64, 4, 4, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        branch = block.eval()(x) - x
        kept = block.train()(x, torch.Generator().manual_seed(1)) - x
        again = block(x, torch.Generator().manual_seed(1)) - x
        assert torch.equal(block(x), branch + x)  # no generator: no drop
    assert torch.equal(kept, again)
    dropped = kept.flatten(1).abs().amax(1) == 0
    assert 10 < dropped.sum() < 54
    np.testing.assert_allclose(_np(kept[~dropped]),
                               _np(branch[~dropped] / 0.5), rtol=1e-6,
                               atol=1e-6)


def test_fused_stem_follows_jax_condition():
    # JAX fuses the stem for a ViT or a ResNet with a patchify stem only
    # (backbone.py:665-667): an EfficientNet or a conv7 ResNet with
    # use_pallas_stem and a patchify stem name takes the plain route
    def fused(backbone, stem):
        return tb.EncoderBackbone(backbone, 0.25, stem=stem,
                                  use_pallas_stem=True,
                                  image_size=(64, 64)).fused

    assert fused("resnet", "patchify8") and fused("resnet", "patchify")
    assert fused("vit_p16_d1_w32_h2", "conv7")
    assert not fused("resnet", "conv7")
    for name in ("efficientnet_lite", "efficientnet_b4", "tiny"):
        assert not fused(name, "patchify8")
    out, ref, _ = _backbone_case("efficientnet_lite", 0.25, "batchnorm")
    ours = _backbone_case("efficientnet_lite", 0.25, "batchnorm")[2]
    twin = tb.EncoderBackbone("efficientnet_lite", 0.25, stem="patchify8",
                              use_pallas_stem=True).eval()
    twin.load_state_dict(ours.state_dict())
    image = _image(np.random.default_rng(3))
    np.testing.assert_array_equal(_np(twin(torch.from_numpy(image))), out)
    with pytest.raises(ValueError, match="unknown backbone"):
        tb.EncoderBackbone("vitp32", image_size=(64, 64))
