"""The whole serving slice of the port (boosted_detr_torch: DETR, the bridge,
``predict`` and the codec) against the JAX package's DETR at a small size,
with the Pallas stem on (run through the interpreter on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.data.codec import TextCodec as TorchCodec
from boosted_detr_tpu.config import ModelConfig as JaxConfig
from boosted_detr_tpu.data.codec import TextCodec as JaxCodec
from boosted_detr_tpu.models.detr import DETR as JaxDETR

torch.set_num_threads(2)

VOCAB = {"category": ["cat", "dog", "bird", "fish", "horse"],
         "attribute": ["red", "green", "blue", "striped", "dotted", "plain"]}
# 64x64 images, 32-channel stages (width 0.01 hits the floor of w(c)), 2+2
# blocks of width 32 with 4 heads, 8 queries, 7 categories and 8
# attributes (the words above plus <PAD> and <OOV>).
SMALL = dict(image_size=(64, 64), backbone="resnet", backbone_width=0.01,
             stem="patchify8", use_pallas_stem=True, norm="batchnorm",
             num_encoder_blocks=2, num_decoder_blocks=2, num_encoder_heads=4,
             num_decoder_heads=4, encoder_dim=32, decoder_dim=32,
             num_object_preds=8, num_categories=7, num_attributes=8)
# float32 compute, outputs are probabilities and boxes of unit scale: the
# sides differ by float32 sum order through 13 conv blocks and 4
# transformer blocks, which measured under 1e-6 here; 1e-5 leaves room.
F32 = dict(atol=1e-5, rtol=1e-5)


def _variables(model, image, seed):
    """Flax init, then seeded noise on every parameter and random running
    statistics, as nested dicts of numpy arrays."""
    rng = np.random.default_rng(seed)
    variables = model.init(jax.random.PRNGKey(0), image)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        scale = 0.3 if leaf == "mean" else 0.1
        return a + (rng.standard_normal(a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _pair(dtype, seed=0):
    cfg = dict(SMALL, compute_dtype=dtype)
    image = np.random.default_rng(seed).uniform(
        -0.05, 1.05, (2, 64, 64, 3)).astype(np.float32)
    jmodel = JaxDETR(JaxConfig(**cfg))
    variables = _variables(jmodel, image, seed)
    ours = bt.DETR(bt.ModelConfig(**cfg), device="cpu").eval()
    bt.load_flax_variables(ours, variables)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return image, jmodel, jvars, ours


def _np(out):
    return {k: v.detach().float().numpy() for k, v in out.items()}


def test_detr_matches_jax_float32():
    image, jmodel, jvars, ours = _pair("float32")
    ref = jmodel.apply(jvars, image, train=False, return_intermediate=True)
    with torch.inference_mode():
        out = ours(torch.from_numpy(image), return_intermediate=True)
        last = ours(torch.from_numpy(image))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        o = _np(o)
        assert o["category"].shape == (2, 8, 7)
        assert o["attribute"].shape == (2, 8, 8)
        assert o["boxes"].shape == (2, 8, 4)
        for key in ("category", "attribute", "boxes"):
            np.testing.assert_allclose(o[key], np.asarray(r[key]), **F32,
                                       err_msg=key)
    for key in ("category", "attribute", "boxes"):
        np.testing.assert_array_equal(last[key].numpy(), out[-1][key].numpy())


def test_detr_bf16_smoke():
    # bfloat16 compute: XLA and torch round at different places through
    # the whole network, so this is a loose check that the bf16 path
    # computes the same model: probabilities and boxes within 5e-2.
    image, jmodel, jvars, ours = _pair("bfloat16", seed=1)
    ref = jmodel.apply(jvars, image, train=False)
    with torch.inference_mode():
        out = _np(ours(torch.from_numpy(image)))
    for key in ("category", "attribute", "boxes"):
        assert out[key].dtype == np.float32
        np.testing.assert_allclose(out[key], np.asarray(ref[key]), atol=5e-2,
                                   rtol=0, err_msg=key)


def test_predict_decodes_like_the_jax_codec():
    image, jmodel, jvars, ours = _pair("float32", seed=2)
    ref = jmodel.apply(jvars, image, train=False)
    want = JaxCodec(VOCAB).decode_predictions(
        {k: np.asarray(v) for k, v in ref.items()})
    got = bt.predict(ours, image, TorchCodec(VOCAB))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], **F32)
    raw = bt.predict(ours, image, TorchCodec(VOCAB), decode_text=False)
    assert set(raw) == {"category", "attribute", "boxes"}


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.DETR(bt.ModelConfig(**SMALL))
