"""The port's ResNet backbone and neck (boosted_detr_torch/models/backbone.py)
against the JAX package's (boosted_detr_tpu/models/backbone.py), with the
Flax parameters and random, non-trivial BatchNorm running statistics carried
across by ``load_flax_variables``. The JAX fused-stem route runs its Pallas
stem kernel through the interpreter on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosted_detr_torch import load_flax_variables
from boosted_detr_torch.models import backbone as tb
from boosted_detr_tpu.models import backbone as jb

torch.set_num_threads(2)

# width 0.01 puts every stage at the 32-channel floor of ``w(c)``
WIDTH = 0.01
# float32 compute through the 13 bottleneck blocks of the patchify8 ResNet:
# the sides differ by float32 sum order in the convolutions (XLA's against
# oneDNN's), which grows with depth to ~1e-5 relative; 1e-4 leaves room.
F32 = dict(atol=1e-4, rtol=1e-4)


def _variables(module, rng, *args, **kw):
    """Flax init, then every parameter shifted by seeded noise and the
    BatchNorm statistics drawn at random (mean ~ N(0, 0.3), var in
    [0.5, 2]), as nested dicts of numpy arrays."""
    variables = module.init(jax.random.PRNGKey(0), *args, **kw)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        scale = 0.3 if leaf == "mean" else 0.1
        return a + (rng.standard_normal(a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(t):
    return t.detach().float().numpy()


def _image(rng, shape=(2, 64, 64, 3)):
    # a little outside [0, 1], so that the clip is exercised
    return rng.uniform(-0.1, 1.1, shape).astype(np.float32)


@pytest.mark.parametrize("preprocessing", ["scale", "imagenet", "caffe"])
def test_fused_stem_route_matches_jax(preprocessing):
    rng = np.random.default_rng(0)
    image = _image(rng)
    jmod = jb.EncoderBackbone("resnet", WIDTH, "batchnorm", jnp.float32,
                              stem="patchify8", preprocessing=preprocessing,
                              use_pallas_stem=True)
    variables = _variables(jmod, rng, image)
    ref = jmod.apply(_jax(variables), image)

    ours = tb.EncoderBackbone("resnet", WIDTH, "batchnorm", torch.float32,
                              stem="patchify8", preprocessing=preprocessing,
                              use_pallas_stem=True).eval()
    assert ours.fused
    load_flax_variables(ours, variables)
    out = ours(torch.from_numpy(image))
    assert out.shape == ref.shape == (2, 2, 2, 32)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **F32)


@pytest.mark.parametrize("stem", ["patchify8", "patchify"])
def test_plain_route_matches_jax(stem):
    rng = np.random.default_rng(1)
    image = _image(rng)
    jmod = jb.EncoderBackbone("resnet", WIDTH, "batchnorm", jnp.float32,
                              stem=stem, preprocessing="imagenet")
    variables = _variables(jmod, rng, image)
    ref = jmod.apply(_jax(variables), image)

    ours = tb.EncoderBackbone("resnet", WIDTH, "batchnorm", torch.float32,
                              stem=stem, preprocessing="imagenet").eval()
    assert not ours.fused
    load_flax_variables(ours, variables)
    np.testing.assert_allclose(_np(ours(torch.from_numpy(image))),
                               np.asarray(ref), **F32)


def test_fused_stem_bf16_smoke():
    # bfloat16 compute through 13 blocks: XLA and torch round the conv
    # outputs at different places, so elementwise bounds are loose; the
    # relative error of the whole map stays near a few bf16 ulps (2**-8).
    rng = np.random.default_rng(2)
    image = _image(rng)
    jmod = jb.EncoderBackbone("resnet", WIDTH, "batchnorm", jnp.bfloat16,
                              stem="patchify8", use_pallas_stem=True)
    variables = _variables(jmod, rng, image)
    ref = np.asarray(jmod.apply(_jax(variables), image), np.float32)
    ours = tb.EncoderBackbone("resnet", WIDTH, "batchnorm", torch.bfloat16,
                              stem="patchify8", use_pallas_stem=True).eval()
    load_flax_variables(ours, variables)
    out = _np(ours(torch.from_numpy(image)))
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 3e-2


def test_stride2_block_pads_same_asymmetrically(monkeypatch):
    # The stride-2 3x3 conv on an even input pads 0 before and 1 after
    # (XLA SAME); torch's padding=1 would pad 1 on both sides.
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    jmod = jb.BottleneckBlock(32, (2, 2), dtype=jnp.float32)
    variables = _variables(jmod, rng, x)
    ref = np.asarray(jmod.apply(_jax(variables), x))

    ours = tb.BottleneckBlock(32, 32, 2, dtype=torch.float32).eval()
    load_flax_variables(ours, variables)
    out = _np(ours(torch.from_numpy(x)))
    assert out.shape == ref.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(out, ref, **F32)

    # the same block with symmetric padding is far off: this test would
    # catch it
    monkeypatch.setattr(tb, "same_padding",
                        lambda size, k, s: (k // 2, k // 2))
    symmetric = _np(ours(torch.from_numpy(x)))
    assert np.abs(symmetric - ref).max() > 0.1


def test_neck_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 2, 2, 64)).astype(np.float32)
    jmod = jb.BackboneNeck(32, dtype=jnp.float32)
    variables = _variables(jmod, rng, feats)
    ref = jmod.apply(_jax(variables), feats)
    ours = tb.BackboneNeck(64, 32, dtype=torch.float32).eval()
    load_flax_variables(ours, variables)
    np.testing.assert_allclose(_np(ours(torch.from_numpy(feats))),
                               np.asarray(ref), **F32)


def test_batchnorm_uses_running_statistics_in_float32():
    # bf16 activations are normalised against the float32 statistics in
    # float32 with eps 1e-3, then cast: compare with that arithmetic done
    # by hand. The variances are small, so that torch's eps 1e-5 would fail.
    rng = np.random.default_rng(5)
    bn = tb.BatchNorm(8, torch.bfloat16).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(8)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(1e-3, 1e-2, 8)))
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(8)))
    x = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(
        np.float32)).bfloat16()
    want = ((x.float() - bn.running_mean)
            * (bn.weight / torch.sqrt(bn.running_var + 1e-3))
            + bn.bias).bfloat16()
    got = bn(x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=0.0,
                               rtol=2 ** -7)
