"""The port's transformer layers (boosted_detr_torch/models/layers.py)
against the JAX package's (boosted_detr_tpu/models/layers.py), with the
Flax parameters carried across by ``load_flax_variables``. Inputs and
parameters are made with numpy from fixed seeds; every parameter is
perturbed away from its init so that LayerNorm scales and biases and the
object queries matter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosted_detr_torch import load_flax_variables
from boosted_detr_torch.models import layers as tl
from boosted_detr_tpu.models import layers as jl

torch.set_num_threads(2)

# float32 compute: the two sides differ by the order of float32 sums and by
# exp/rsqrt rounding. Over a few blocks of width 32 that stays under ~2e-5
# on outputs of unit scale after LayerNorm; 1e-4 leaves room.
F32 = dict(atol=1e-4, rtol=1e-4)
# bfloat16 compute: one bf16 rounding is 2**-8 relative, and XLA and torch
# round the Dense outputs at different places (torch's bias add is fused
# before the rounding); after LayerNorm the outputs are of unit scale, so a
# few ulps are ~5e-2.
BF16 = dict(atol=6e-2, rtol=6e-2)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _perturbed(variables, rng, noise=0.1):
    """Flax variables -> nested dicts of numpy arrays, every leaf shifted by
    seeded noise."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + _normal(rng, a.shape, noise),
        variables)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(ours, ref, tol):
    np.testing.assert_allclose(ours.float().detach().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_trig_positional_init_is_identical():
    np.testing.assert_array_equal(tl.trig_positional_init(37, 24),
                                  jl.trig_positional_init(37, 24))


@pytest.mark.parametrize("tq,tk", [(5, 5), (6, 9)])
def test_multihead_attention(tq, tk):
    rng = np.random.default_rng(0)
    q, k = _normal(rng, (2, tq, 32)), _normal(rng, (2, tk, 32))
    v = _normal(rng, (2, tk, 32))
    jmod = jl.MultiheadAttention(4, dtype=jnp.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), q, k, v), rng)
    ref = jmod.apply(_jax(params), q, k, v)

    ours = tl.MultiheadAttention(32, 4, torch.float32)
    load_flax_variables(ours, params)
    _close(ours(_t(q), _t(k), _t(v)), ref, F32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("post_softmax", [True, False])
def test_multihead_attention_with_a_mask(post_softmax, use_pallas):
    """A mask (1 = keep, broadcast over the heads) multiplies the
    probabilities after the softmax without renormalising them, or masks
    the logits before it; a masked call takes the plain route even with
    ``use_pallas`` (layers.py:104, :125-133)."""
    rng = np.random.default_rng(1)
    q, k = _normal(rng, (2, 6, 32)), _normal(rng, (2, 9, 32))
    v = _normal(rng, (2, 9, 32))
    mask = (rng.uniform(size=(2, 1, 6, 9)) > 0.4).astype(np.float32)
    mask[..., 0] = 1.0  # every query keeps a key
    # init and the unmasked call on the plain route (the same tree): the
    # Pallas kernel runs on the CPU in interpret mode only
    plain = jl.MultiheadAttention(4, dtype=jnp.float32)
    params = _perturbed(plain.init(jax.random.PRNGKey(0), q, k, v), rng)
    jmod = jl.MultiheadAttention(4, dtype=jnp.float32,
                                 post_softmax_mask=post_softmax,
                                 use_pallas=use_pallas)
    ref = jmod.apply(_jax(params), q, k, v, jnp.asarray(mask))
    unmasked = plain.apply(_jax(params), q, k, v)
    assert np.abs(np.asarray(ref) - np.asarray(unmasked)).max() > 1e-2

    ours = tl.MultiheadAttention(32, 4, torch.float32, use_pallas=use_pallas,
                                 post_softmax_mask=post_softmax)
    load_flax_variables(ours, params)
    _close(ours(_t(q), _t(k), _t(v), _t(mask)), ref, F32)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_encoder_block(dtype, tol):
    rng = np.random.default_rng(1)
    feats, pos = _normal(rng, (2, 12, 32)), _normal(rng, (2, 12, 32))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jmod = jl.EncoderBlock(4, dtype=jdt)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), feats, pos), rng)
    ref = jmod.apply(_jax(params), jnp.asarray(feats, jdt), pos)

    ours = tl.EncoderBlock(32, 4, 1e-3, tdt)
    load_flax_variables(ours, params)
    _close(ours(_t(feats).to(tdt), _t(pos)), ref, tol)


@pytest.mark.parametrize("self_attention", [False, True])
def test_decoder_block(self_attention):
    rng = np.random.default_rng(2)
    enc_v, enc_k = _normal(rng, (2, 12, 32)), _normal(rng, (2, 12, 32))
    dec = _normal(rng, (2, 6, 32))
    jmod = jl.DecoderBlock(4, self_attention=self_attention,
                           dtype=jnp.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), enc_v, dec, enc_k),
                        rng)
    ref = jmod.apply(_jax(params), enc_v, dec, enc_k)

    ours = tl.DecoderBlock(32, 4, 1e-3, torch.float32,
                           self_attention=self_attention)
    # decoder block 0 has no self-attention: no parameters for it either
    assert (ours.self_attention is None) == (not self_attention)
    load_flax_variables(ours, params)
    _close(ours(_t(enc_v), _t(dec), _t(enc_k)), ref, F32)


def test_image_encoder_and_decoder_prep():
    rng = np.random.default_rng(3)
    grid = _normal(rng, (2, 3, 4, 32))
    jenc = jl.ImageEncoder(2, 4, dtype=jnp.float32)
    penc = _perturbed(jenc.init(jax.random.PRNGKey(0), grid), rng)
    tokens, pos = jenc.apply(_jax(penc), grid)

    jprep = jl.DecoderPrep(6, 32, dtype=jnp.float32)
    pprep = _perturbed(jprep.init(jax.random.PRNGKey(0), tokens, pos), rng)
    ref = jprep.apply(_jax(pprep), tokens, pos)

    enc = tl.ImageEncoder((3, 4), 32, 2, 4, 1e-3, torch.float32)
    load_flax_variables(enc, penc)
    prep = tl.DecoderPrep(6, 32, torch.float32)
    load_flax_variables(prep, pprep)
    ours_tokens, ours_pos = enc(_t(grid))
    _close(ours_tokens, tokens, F32)
    _close(ours_pos, pos, F32)
    for o, r in zip(prep(ours_tokens, ours_pos), ref):
        _close(o, r, F32)
