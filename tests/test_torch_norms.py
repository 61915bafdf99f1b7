"""The port's norms and norm-free pieces (boosted_detr_torch/models/
backbone.py: ``GroupNorm``/``AdaptiveGroupNorm``, ``make_norm``'s
``skipinit``, the weight-standardised ``Conv`` and ``PatchifyConv``,
``skip_gain``, the ``conv7`` stem with its SAME max pool, the neck under
``skipinit``) against the JAX package's, on the CPU, at tiny widths,
float32, ``train=False``. Weights: the Flax tree's shapes
(``jax.eval_shape`` of its init) filled with seeded draws, every leaf off
its init (``skip_gain`` included, so that no residual branch sits at its
zero), random running statistics; the same numbers enter both packages
through ``load_flax_variables``. JAX applies under ``jax.jit`` (eager JAX
compiles each op on its first call, several times slower here); its fused
stem runs its Pallas kernel through the interpreter on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tb
from boosted_detr_tpu.models import backbone as jb

torch.set_num_threads(2)

# float32 on both sides: the sides differ by float32 sum order (XLA's
# convolutions and reductions against oneDNN's and torch's); measured under
# 2e-6 on outputs of unit scale.
F32 = dict(atol=1e-5, rtol=1e-5)


def draw(shapes, rng):
    """A Flax variable tree of the shapes ``shapes`` as nested numpy dicts,
    every leaf drawn from ``rng``: kernels at 1/sqrt(fan_in), norm scales
    and WS gains around 1, ``skip_gain`` around 0.5, biases, means and
    embeddings with noise, BatchNorm variances in [0.5, 2]."""

    def leaf(path, s):
        shape, name = s.shape, path[-1].key
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name in ("scale", "gain"):
            return 1.0 + 0.1 * noise
        if name == "skip_gain":
            return 0.5 + 0.1 * noise
        return (0.3 if name == "mean" else 0.1) * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def variables_for(jmod, rng, *args, **kw):
    return draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args,
                               **kw), rng)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(t):
    return t.detach().float().numpy()


def _image(rng, shape=(2, 64, 64, 3)):
    # a little outside [0, 1], so that the clip is exercised
    return rng.uniform(-0.1, 1.1, shape).astype(np.float32)


def pair(jmod, ours, rng, *args):
    """(JAX output, the port module in eval mode) from the same drawn
    weights."""
    variables = variables_for(jmod, rng, *args)
    ref = np.asarray(jax.jit(jmod.apply)(_jax(variables), *args))
    bt.load_flax_variables(ours.eval(), variables)
    return ref, ours


@pytest.mark.parametrize("shape, groups", [
    ((2, 5, 7, 24), 24), ((2, 4, 4, 40), 20), ((2, 3, 3, 144), 24),
    ((3, 16, 40), 20)])
def test_group_norm_matches_flax(shape, groups):
    # odd widths take the largest divisor <= 32; [B, T, C] tokens (the
    # heads) reduce over T and the group's channels
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    ref, ours = pair(jb._AdaptiveGroupNorm(jnp.float32),
                     tb.AdaptiveGroupNorm(shape[-1], torch.float32), rng, x)
    assert ours.gn.groups == groups
    np.testing.assert_allclose(_np(ours(torch.from_numpy(x))), ref, **F32)
    # no running statistics: training mode computes the same
    np.testing.assert_allclose(_np(ours.train()(torch.from_numpy(x))), ref,
                               **F32)


def test_make_norm_names():
    skip = tb.make_norm("skipinit", 8, torch.float32)
    assert isinstance(skip, torch.nn.Identity) and not list(skip.parameters())
    assert isinstance(tb.make_norm("groupnorm", 8, torch.float32),
                      tb.AdaptiveGroupNorm)
    with pytest.raises(ValueError, match="unknown norm"):
        tb.make_norm("layernorm", 8, torch.float32)


@pytest.mark.parametrize("cin, cout, kernel, stride, groups", [
    (8, 16, 3, 1, 1), (8, 16, 3, 2, 1), (12, 9, 3, 1, 3), (16, 16, 5, 2, 16),
    (6, 4, 1, 1, 1)])
def test_ws_conv_matches_flax(cin, cout, kernel, stride, groups):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 8, cin)).astype(np.float32)
    jmod = jb.WSConv(cout, (kernel, kernel), (stride, stride), groups,
                     jnp.float32)
    ours = tb.Conv(cin, cout, kernel, stride, groups=groups,
                   weight_standardized=True)
    ref, ours = pair(jmod, ours, rng, x)
    out = _np(ours(torch.from_numpy(x), torch.float32))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **F32)


def test_standardize_uses_the_population_variance():
    w = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    s = tb.standardize(w, torch.ones(4))
    # mean 0, variance var / (fan_in var + 1e-4) per output channel
    var = w.var((1, 2, 3), correction=0)
    np.testing.assert_allclose(s.mean((1, 2, 3)).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(s.var((1, 2, 3), correction=0).numpy(),
                               (var / (12 * var + 1e-4)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("preprocessing", ["scale", "imagenet", "caffe"])
def test_fused_ws_stem_matches_jax(preprocessing):
    # the skipinit stem: K1-fwd's plain version on standardised weights,
    # against JAX's Pallas stem (interpreter), through 13 norm-free blocks
    rng = np.random.default_rng(2)
    image = _image(rng)
    kw = dict(stem="patchify8", preprocessing=preprocessing,
              use_pallas_stem=True)
    jmod = jb.EncoderBackbone("resnet", 0.01, "skipinit", jnp.float32, **kw)
    ours = tb.EncoderBackbone("resnet", 0.01, "skipinit", torch.float32, **kw)
    assert ours.fused and ours.net.stem.conv.gain is not None
    assert ours.net.stem.norm is None
    ref, ours = pair(jmod, ours, rng, image)
    # caffe's 0-255 inputs give outputs of ~40: 1e-5 of the output's scale
    np.testing.assert_allclose(_np(ours(torch.from_numpy(image))), ref,
                               atol=1e-5 * max(1.0, np.abs(ref).max()),
                               rtol=1e-5)


@pytest.mark.parametrize("side", [32, 33])
def test_conv7_stem_pools_same_asymmetrically(side, monkeypatch):
    # the 7x7/s2 conv and the 3x3/s2 max pool both pad 0 before and 1 after
    # an even side (SAME); a pool padded on both sides is far off
    rng = np.random.default_rng(4)
    image = _image(rng, (2, side, side, 3))
    jmod = jb.EncoderBackbone("resnet", 0.01, "batchnorm", jnp.float32,
                              stem="conv7")
    ours = tb.EncoderBackbone("resnet", 0.01, "batchnorm", torch.float32,
                              stem="conv7")
    assert ours.net.pool and not ours.fused
    ref, ours = pair(jmod, ours, rng, image)
    out = _np(ours(torch.from_numpy(image)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **F32)

    x = torch.from_numpy(rng.standard_normal((2, side, side, 4))
                         .astype(np.float32))
    want = np.asarray(jax.lax.reduce_window(  # nn.max_pool's SAME
        jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
        (1, 2, 2, 1), "SAME"))
    np.testing.assert_array_equal(_np(tb.max_pool_same(x)), want)
    if side % 2 == 0:
        monkeypatch.setattr(tb, "same_padding", lambda size, k, s: (1, 1))
        symmetric = _np(tb.max_pool_same(x))
        assert symmetric.shape == want.shape
        assert np.abs(symmetric - want).max() > 0.1


@pytest.mark.parametrize("stem", ["conv7", "patchify", "patchify8"])
def test_skipinit_resnet_matches_jax(stem):
    rng = np.random.default_rng(5)
    image = _image(rng)
    jmod = jb.EncoderBackbone("resnet", 0.01, "skipinit", jnp.float32,
                              stem=stem, preprocessing="imagenet")
    ours = tb.EncoderBackbone("resnet", 0.01, "skipinit", torch.float32,
                              stem=stem, preprocessing="imagenet")
    assert not ours.fused
    ref, ours = pair(jmod, ours, rng, image)
    assert not any("running" in k for k in ours.state_dict())
    np.testing.assert_allclose(_np(ours(torch.from_numpy(image))), ref,
                               **F32)


@pytest.mark.parametrize("stride", [1, 2])
def test_groupnorm_block_matches_jax(stride):
    # GroupNorm through a whole ResNet at these widths is ill-conditioned:
    # a last stage of 2x2 maps with one channel a group has 4 values a
    # group, whose fast variance cancels, so a 1e-7 relative change of the
    # image moves the port's own output by ~5e-3. A block at 8x8 with 4
    # channels a group is well-conditioned.
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    ref, ours = pair(jb.BottleneckBlock(128, (stride, stride), "groupnorm",
                                        jnp.float32),
                     tb.BottleneckBlock(64, 128, stride, "groupnorm",
                                        torch.float32), rng, x)
    assert ours.conv3.norm.gn.groups == 32
    np.testing.assert_allclose(_np(ours(torch.from_numpy(x))), ref, **F32)


def test_skipinit_block_scales_its_branch_by_skip_gain():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    ref, ours = pair(jb.BottleneckBlock(32, (2, 2), "skipinit", jnp.float32),
                     tb.BottleneckBlock(32, 32, 2, "skipinit",
                                        torch.float32), rng, x)
    assert ours.skip_gain.shape == () and ours.conv1.norm is None
    np.testing.assert_allclose(_np(ours(torch.from_numpy(x))), ref, **F32)
    # at its zero init the branch is gone: the block is relu(proj(x))
    with torch.no_grad():
        ours.skip_gain.zero_()
        want = torch.relu(ours.proj(torch.from_numpy(x)))
        np.testing.assert_array_equal(_np(ours(torch.from_numpy(x))),
                                      _np(want))


def test_neck_takes_groupnorm_under_skipinit():
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, 3, 3, 40)).astype(np.float32)
    ref, ours = pair(jb.BackboneNeck(24, "skipinit", jnp.float32),
                     tb.BackboneNeck(40, 24, "skipinit", torch.float32),
                     rng, feats)
    assert isinstance(ours.norm1, tb.AdaptiveGroupNorm)
    np.testing.assert_allclose(_np(ours(torch.from_numpy(feats))), ref,
                               **F32)


_FIELD_CASES = {}


def _field_case(norm, stem, preprocessing):
    """(port output, JAX output) of a width-0.01 ResNet at 32x32 (a 1x1
    last stage), once per setting."""
    key = (norm, stem, preprocessing)
    if key not in _FIELD_CASES:
        image = _image(np.random.default_rng(9), (2, 32, 32, 3))
        kw = dict(stem=stem, preprocessing=preprocessing)
        ref, ours = pair(
            jb.EncoderBackbone("resnet", 0.01, norm, jnp.float32, **kw),
            tb.EncoderBackbone("resnet", 0.01, norm, torch.float32, **kw),
            np.random.default_rng(10), image)
        _FIELD_CASES[key] = (_np(ours(torch.from_numpy(image))), ref)
    return _FIELD_CASES[key]


@pytest.mark.parametrize("field, values", [
    ("norm", ("batchnorm", "groupnorm", "skipinit")),
    ("stem", ("conv7", "patchify")),
    ("preprocessing", ("scale", "caffe"))])
def test_resnet_fields_move_the_output_as_in_jax(field, values):
    # each field the new ResNet pieces read moves the port's output as it
    # moves JAX's
    base = dict(norm="skipinit", stem="conv7", preprocessing="scale")
    outs = []
    for value in values:
        out, ref = _field_case(**dict(base, **{field: value}))
        np.testing.assert_allclose(out, ref, atol=1e-5 * max(
            1.0, np.abs(ref).max()), rtol=1e-5)
        outs.append((out, ref))
    for (o0, r0), (o1, r1) in zip(outs, outs[1:]):
        assert np.abs(o0 - o1).max() > 1e-3
        assert np.abs(r0 - r1).max() > 1e-3
