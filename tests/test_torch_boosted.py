"""The port's boosted ensemble (boosted_detr_torch.models.boosted) against
the JAX package's ``BoostedDETR`` on the CPU, at a tiny size: the shapes of
tests/test_boosted_pretrainer.py::TINY (3 weak learners of width 16, 2
heads, 8 queries, 6 categories, 4 attributes) on the port's ResNet
``patchify8`` backbone at width 0.01 and 64x64 (a 2x2 grid), float32,
``train=False``. Weights: the JAX tree's shapes (``jax.eval_shape`` of its
init) filled with seeded draws at the Flax initialisers' scales, random
running statistics; the same numbers go into both packages through
``load_flax_variables``. JAX runs eagerly: one apply of this model costs
~0.6 s there, a jitted init ~13 s."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_tpu.config import ModelConfig as JaxConfig
from boosted_detr_tpu.models.boosted import BoostedDETR as JaxBoosted

torch.set_num_threads(2)

TINY = dict(num_object_preds=8, image_size=(64, 64), num_encoder_blocks=2,
            num_encoder_heads=2, encoder_dim=16, num_decoder_blocks=3,
            num_decoder_heads=2, decoder_dim=16, num_categories=6,
            num_attributes=4, backbone="resnet", backbone_width=0.01,
            stem="patchify8", compute_dtype="float32", max_objects=3,
            dropout_rate=0.0)
# float32 on both sides: the sums run in other orders through 13 conv
# blocks and 6 transformer blocks; measured under 1.2e-6 here.
F32 = dict(atol=1e-5, rtol=1e-5)
# The variants: (config keywords, focused_training_layer).
VARIANTS = {
    "fresh": ({}, None),
    "carry": (dict(boosted_queries="carry"), None),
    "confidence_0.0": (dict(boosted_queries="confidence",
                            boosted_carry_threshold=0.0), None),
    "confidence_0.5": (dict(boosted_queries="confidence",
                            boosted_carry_threshold=0.5), None),
    "confidence_1.1": (dict(boosted_queries="confidence",
                            boosted_carry_threshold=1.1), None),
    "double_count": (dict(block0_double_count=True), None),
    "shared_encoder": (dict(boosted_shared_encoder=True), None),
    "shared_encoder_depth_1": (dict(boosted_shared_encoder=True,
                                    num_encoder_blocks=1), None),
    "focused_0": ({}, 0),
    "focused_2": ({}, 2),
}


def tiny_variables(model, image, seed):
    """The Flax tree of ``model`` at ``image``'s shape, every leaf drawn
    from ``seed``: kernels at 1/sqrt(fan_in) (the heads' output layers at
    4/sqrt(fan_in)), object queries at 1 (so that the slots differ and the
    category confidences spread over most of (1/6, 1)), biases, norm
    scales (around 1) and positional encodings with noise, running means
    and variances at random."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), image)

    def draw(path, leaf):
        shape, name = leaf.shape, path[-1].key
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "kernel":
            gain = 4.0 if path[-2].key in ("logits", "box_coords") else 1.0
            return noise * np.float32(gain / np.sqrt(np.prod(shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * noise
        if name == "object_queries":
            return noise
        return (0.3 if name == "mean" else 0.1) * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _image(seed, b=2):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (b, 64, 64, 3)).astype(np.float32)


def _np(out):
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port(cfg, variables, focused=None):
    model = bt.BoostedDETR(bt.ModelConfig(**cfg), device="cpu",
                           focused_training_layer=focused).eval()
    bt.load_flax_variables(model, variables)
    return model


@pytest.fixture(scope="module")
def reference():
    """Every variant's JAX forward, with and without the intermediate
    outputs, on one image batch; the shared-encoder variants have their own
    tree (``encoder_shared`` in place of ``encoder_{i}``)."""
    image = _image(0)
    trees = {}
    ref = {"image": image, "trees": trees, "outs": {}}
    for name, (kw, focused) in VARIANTS.items():
        cfg = dict(TINY, **kw)
        jmodel = JaxBoosted(JaxConfig(**cfg), focused_training_layer=focused)
        key = (kw.get("boosted_shared_encoder", False),
               cfg["num_encoder_blocks"])
        if key not in trees:
            trees[key] = tiny_variables(jmodel, image, seed=len(trees) + 1)
        variables = trees[key]
        for intermediate in (True, False):
            out = jmodel.apply(variables, image,
                               return_intermediate=intermediate)
            ref["outs"][name, intermediate] = (
                [_np(o) for o in out] if intermediate else _np(out))
    return ref


def _variables(reference, name):
    kw = VARIANTS[name][0]
    return reference["trees"][kw.get("boosted_shared_encoder", False),
                              kw.get("num_encoder_blocks", 2)]


@pytest.mark.parametrize("intermediate", [True, False])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(reference, name, intermediate):
    kw, focused = VARIANTS[name]
    model = _port(dict(TINY, **kw), _variables(reference, name), focused)
    with torch.inference_mode():
        out = model(torch.from_numpy(reference["image"]),
                    return_intermediate=intermediate)
    ref = reference["outs"][name, intermediate]
    if intermediate:
        # a focused forward returns its block's output alone
        assert len(out) == len(ref) == (1 if focused is not None else 3)
    else:
        out, ref = [out], [ref]
    for o, r in zip(out, ref):
        assert o["category"].shape == (2, 8, 6)
        assert o["attribute"].shape == (2, 8, 4)
        assert o["boxes"].shape == (2, 8, 4)
        for key in ("category", "attribute", "boxes"):
            np.testing.assert_allclose(o[key].numpy(), r[key], **F32,
                                       err_msg=f"{name} {key}")


def test_confidence_thresholds_are_clear_of_rounding(reference):
    """At threshold 0.5 a slot freezes where the float32 max of the
    carried category output reaches 0.5: no slot sits within 1e-4 of it,
    so that rounding cannot flip a freeze, and both outcomes occur."""
    outs = reference["outs"]["confidence_0.5", True]
    conf = np.stack([o["category"].max(-1) for o in outs])
    assert np.abs(conf - 0.5).min() > 1e-4
    assert (conf >= 0.5).any() and (conf < 0.5).any()
    # threshold 0 freezes every slot at block 0; 1.1 none
    at0 = reference["outs"]["confidence_0.0", True]
    for o in at0[1:]:
        np.testing.assert_array_equal(o["category"], at0[0]["category"])


def test_focusing_shares_the_weights(reference):
    """``model.focused(k)`` is the constructor's ``focused_training_layer``
    on the same parameters, and is undone when its block ends."""
    model = _port(TINY, _variables(reference, "focused_2"))
    image = torch.from_numpy(reference["image"])
    with torch.inference_mode():
        with model.focused(2) as same:
            assert same is model
            out = model(image, return_intermediate=True)
        full = model(image, return_intermediate=True)
    assert model.focused_training_layer is None and len(full) == 3
    assert len(out) == 1
    for key in ("category", "attribute", "boxes"):
        np.testing.assert_array_equal(out[0][key].numpy(),
                                      full[2][key].numpy())
        np.testing.assert_allclose(
            out[0][key].numpy(), reference["outs"]["focused_2", False][key],
            **F32)


# Each field BoostedDETR reads for its ensemble, and the variant that sets
# it against the one that does not.
FIELDS = {"boosted_queries": ("carry", "fresh"),
          "boosted_carry_threshold": ("confidence_0.5", "confidence_1.1"),
          "block0_double_count": ("double_count", "fresh"),
          "boosted_shared_encoder": ("shared_encoder", "fresh"),
          "num_encoder_blocks": ("shared_encoder_depth_1", "shared_encoder")}


@pytest.mark.parametrize("field", list(FIELDS))
def test_each_config_field_moves_the_output_as_jax(reference, field):
    """Setting the field moves JAX's last-block output; the port's moves by
    the same amount (each side matches JAX within F32, above)."""
    moved = {}
    for side in ("jax", "port"):
        outs = []
        for name in FIELDS[field]:
            if side == "jax":
                outs.append(reference["outs"][name, False])
                continue
            kw, focused = VARIANTS[name]
            model = _port(dict(TINY, **kw), _variables(reference, name),
                          focused)
            with torch.inference_mode():
                outs.append(_np(model(torch.from_numpy(
                    reference["image"]))))
        moved[side] = {k: outs[0][k] - outs[1][k] for k in outs[0]}
    for key in ("category", "attribute", "boxes"):
        assert np.abs(moved["jax"][key]).max() > 1e-3, (field, key)
        np.testing.assert_allclose(moved["port"][key], moved["jax"][key],
                                   atol=2e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("shared", [False, True])
def test_bridge_round_trips_the_boosted_scopes(reference, shared):
    name = "shared_encoder" if shared else "fresh"
    variables = _variables(reference, name)
    model = _port(dict(TINY, **VARIANTS[name][0]), variables)
    layout = bt.to_flax_layout(model, model.state_dict())
    for collection in ("params", "batch_stats"):
        ours = jax.tree_util.tree_leaves_with_path(layout[collection])
        want = dict(jax.tree_util.tree_leaves_with_path(
            variables[collection]))
        assert len(ours) == len(want)
        for path, leaf in ours:
            np.testing.assert_array_equal(leaf, want[path])
    tops = set(variables["params"])
    encoders = ({"encoder_shared"} if shared
                else {f"encoder_{i}" for i in range(3)})
    assert tops == {"backbone", "neck", "decoder_prep", *encoders} | {
        f"{part}_{i}" for i in range(3)
        for part in ("decoder_block", "category_head", "attribute_head",
                     "box_head")}
    # the heads' hidden width is decoder_dim (boosted.py:107-123), not
    # DETR's 4 * decoder_dim
    cfg = model.config
    assert cfg.resolved_head_hidden_dim == 64
    for i in range(3):
        for part in ("category_head", "attribute_head", "box_head"):
            head = getattr(model, f"{part}_{i}")
            assert head.dense.weight.shape == (cfg.decoder_dim,
                                               cfg.decoder_dim)
    # block 0 has no self-attention
    assert model.decoder_block_0.self_attention is None
    assert model.decoder_block_1.self_attention is not None


def test_parameter_count_matches_jax(reference):
    for name in ("fresh", "shared_encoder"):
        variables = _variables(reference, name)
        model = _port(dict(TINY, **VARIANTS[name][0]), variables)
        want = sum(np.size(v) for v in jax.tree_util.tree_leaves(
            variables["params"]))
        assert sum(p.numel() for p in model.parameters()) == want


def test_boosted_needs_a_card_or_an_explicit_cpu(monkeypatch):
    cfg = bt.ModelConfig(**TINY)
    model = bt.BoostedDETR(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    assert not hasattr(model, "encoder")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.BoostedDETR(cfg)
    with pytest.raises(ValueError, match="boosted_queries"):
        bt.BoostedDETR(dataclasses.replace(cfg, boosted_queries="stale"),
                       device="cpu")


def test_flagship_parameter_count_matches_jax():
    """The boosted path of chip_smoke.py (the 640 flagship's widths, as
    ``BENCH_MODEL=boosted`` builds it): 29,334,520 parameters in both
    packages, against DETR's 28,824,190."""
    kw = dict(image_size=(640, 640), backbone="resnet", stem="patchify8",
              norm="batchnorm", compute_dtype="bfloat16", max_objects=32,
              num_categories=82, num_attributes=296)
    shapes = jax.eval_shape(JaxBoosted(JaxConfig(**kw)).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 640, 640, 3),
                                                 np.float32))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert want == 29_334_520
    model = bt.BoostedDETR(bt.ModelConfig(**kw, use_pallas_stem=True),
                           device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want
