"""The port's panoptic model (boosted_detr_torch/models/panoptic.py) against
the JAX package's on the CPU: each block (the attention maps, the down and
up blocks at odd and even sizes, the neck with and without antialiasing),
``DETRPanoptic``'s forward at ``return_intermediate`` both ways with 1 and
2 panoptic heads, ``masks_from_boxes``, ``dice_loss`` and ``mask_loss``,
the config fields the model reads and the parameter count at the
640 flagship's config. The model is
tests/test_torch_boosted.py's TINY (ResNet ``patchify8`` at width 0.01,
64x64 images, a 2x2 grid, 8 queries) with 2 decoder blocks and mask size
16, weights drawn on ``jax.eval_shape``'s tree and carried across by
``load_flax_variables``; JAX runs under ``jax.jit`` (an eager apply of
this model costs ~14 s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import panoptic as tp
from boosted_detr_tpu.config import ModelConfig as JaxConfig
from boosted_detr_tpu.models import panoptic as jp
from test_torch_boosted import TINY, tiny_variables

torch.set_num_threads(2)

CFG = dict(TINY, num_decoder_blocks=2)
MASK = 16
# float32 on both sides: the sums run in other orders through the trunk
# and the U-Net; the mask logits (a few units large) measured within 2e-6.
F32 = dict(atol=1e-4, rtol=1e-4)
# The variants: (config keywords, mask size); each field the model reads
# is set in one of them.
VARIANTS = {"base": ({}, MASK),
            "heads_2": (dict(num_panoptic_heads=2), MASK),
            "dim_48": (dict(panoptic_dim=48), MASK),
            "mask_24": ({}, 24)}


def _image(seed, b=2):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (b, 64, 64, 3)).astype(np.float32)


def _np(out):
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def reference():
    """Every variant's tree and jitted JAX forward with every block's
    output (its last is JAX's final output: the same computation)."""
    image = _image(0)
    ref = {"image": image, "trees": {}, "outs": {}}
    for i, (name, (kw, mask)) in enumerate(VARIANTS.items()):
        jmodel = jp.DETRPanoptic(JaxConfig(**CFG, **kw), mask_size=mask)
        variables = tiny_variables(jmodel, image, seed=i + 1)
        ref["trees"][name] = variables
        outs = jax.jit(lambda v, x: jmodel.apply(
            v, x, return_intermediate=True))(variables, image)
        ref["outs"][name, True] = [_np(o) for o in outs]
    return ref


def _port(name, variables, **over):
    kw, mask = VARIANTS[name]
    model = bt.DETRPanoptic(bt.ModelConfig(**dict(CFG, **kw, **over)),
                            mask_size=mask, device="cpu").eval()
    bt.load_flax_variables(model, variables)
    return model


@pytest.mark.parametrize("name,intermediate", [
    ("base", True), ("base", False), ("heads_2", True), ("heads_2", False)])
def test_forward_matches_jax(reference, name, intermediate):
    model = _port(name, reference["trees"][name])
    with torch.inference_mode():
        out = model(torch.from_numpy(reference["image"]),
                    return_intermediate=intermediate)
    ref = reference["outs"][name, True]
    if not intermediate:
        ref = ref[-1]
    if intermediate:
        assert len(out) == len(ref) == 2
    else:
        out, ref = [out], [ref]
    for o, r in zip(out, ref):
        assert o["masks"].shape == (2, 8, MASK, MASK)
        assert o["masks"].dtype == torch.float32
        assert set(o) == set(r) == {"category", "attribute", "boxes",
                                    "masks"}
        for key in r:
            np.testing.assert_allclose(o[key].numpy(), r[key], **F32,
                                       err_msg=f"{name} {key}")


# each field the panoptic model reads, and the variant that sets it
FIELDS = {"num_panoptic_heads": "heads_2", "panoptic_dim": "dim_48",
          "mask_size": "mask_24"}


@pytest.mark.parametrize("field", list(FIELDS))
def test_each_config_field_moves_the_masks_as_jax(reference, field):
    """The variant's masks differ from the base's on both sides (by shape
    for ``mask_size``), and the port's are JAX's within F32."""
    name = FIELDS[field]
    model = _port(name, reference["trees"][name])
    with torch.inference_mode():
        outs = model(torch.from_numpy(reference["image"]),
                     return_intermediate=True)
    ref = reference["outs"][name, True]
    base = reference["outs"]["base", True]
    for o, r, b in zip(outs, ref, base):
        if r["masks"].shape == b["masks"].shape:
            assert np.abs(r["masks"] - b["masks"]).max() > 1e-2
        np.testing.assert_allclose(o["masks"].numpy(), r["masks"], **F32)
    if field == "mask_size":
        assert outs[-1]["masks"].shape[-1] == 24


def test_panoptic_attention_matches_jax():
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((2, 6, 16)).astype(np.float32)
    pos = rng.standard_normal((2, 6, 16)).astype(np.float32)
    dec = rng.standard_normal((2, 5, 12)).astype(np.float32)
    jmod = jp.PanopticAttention(2, 8)
    variables = jax.jit(jmod.init, static_argnums=4)(
        jax.random.PRNGKey(0), tokens, pos, dec, (2, 3))
    ref = jax.jit(jmod.apply, static_argnums=4)(variables, tokens, pos, dec,
                                                 (2, 3))
    mod = tp.PanopticAttention(2, 8, 12, 16, torch.float32)
    bt.load_flax_variables(mod, jax.tree_util.tree_map(np.asarray, variables))
    out = mod(*(torch.from_numpy(a) for a in (tokens, pos, dec)), (2, 3))
    assert out.shape == (2, 2, 3, 10)  # channel h * Q + q
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("block", ["down", "up"])
@pytest.mark.parametrize("size", [5, 8])
def test_down_and_up_blocks_match_jax_at_odd_and_even_sizes(block, size):
    """Flax's stride-2 SAME conv (0 before and 1 after on an even side, 1
    and 1 on an odd one) and its SAME ConvTranspose (H -> 2H at either
    parity, the kernel unflipped), each with the float32 LayerNorm at eps
    1e-6 and the leaky ReLU."""
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 6)).astype(np.float32)
    jcls, tcls = ((jp._DownBlock, tp._DownBlock) if block == "down"
                  else (jp._UpBlock, tp._UpBlock))
    jmod = jcls(7)
    variables = tiny_variables(jmod, x, seed=size)
    ref = np.asarray(jax.jit(jmod.apply)(variables, x))
    mod = tcls(6, 7, torch.float32)
    bt.load_flax_variables(mod, variables)
    out = mod(torch.from_numpy(x)).detach().numpy()
    want = (size + 1) // 2 if block == "down" else 2 * size
    assert out.shape == ref.shape == (2, want, want, 7)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    # the bridge carries the deconv kernel back to Flax's layout
    back = bt.to_flax_layout(mod, dict(mod.named_parameters()))["params"]
    for leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        path, value = leaf
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, value)


@pytest.mark.parametrize("grid,mask", [((2, 2), 16), ((12, 12), 8)])
def test_neck_matches_jax_upsampling_and_antialiased(grid, mask):
    """The neck's resize: bilinear up from the grid, and, where the grid is
    larger than the mask (images over 32 x mask_size pixels), JAX's
    antialiased downsampling."""
    maps = np.random.default_rng(7).uniform(
        0, 1, (2, *grid, 6)).astype(np.float32)
    jmod = jp.PanopticNeck(num_preds=3, width=32, mask_size=mask)
    variables = tiny_variables(jmod, maps, seed=8)
    ref = np.asarray(jax.jit(jmod.apply)(variables, maps))
    mod = tp.PanopticNeck(6, 3, width=32, mask_size=mask)
    bt.load_flax_variables(mod, variables)
    out = mod(torch.from_numpy(maps)).detach().numpy()
    assert out.shape == ref.shape == (2, 3, mask, mask)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _mask_problem(seed, b=3, o=4, p=6, s=8):
    rng = np.random.default_rng(seed)
    bbox = rng.uniform(0.05, 0.5, (b, o, 4)).astype(np.float32)
    n = np.array([0, 2, o], np.int32)[:b]
    logits = (rng.standard_normal((b, p, s, s)) * 2).astype(np.float32)
    assign = np.zeros((b, o, p), np.float32)
    for i in range(b):
        cols = rng.permutation(p)[:n[i]]
        assign[i, np.arange(n[i]), cols] = 1.0
    return bbox, n, logits, assign


def test_masks_from_boxes_dice_and_mask_loss_match_jax():
    bbox, n, logits, assign = _mask_problem(5)
    targets = tp.masks_from_boxes(torch.from_numpy(bbox), torch.from_numpy(n),
                                  8)
    ref_targets = np.asarray(jp.masks_from_boxes(jnp.asarray(bbox),
                                                 jnp.asarray(n), 8))
    np.testing.assert_array_equal(targets.numpy(), ref_targets)
    assert targets[0].sum() == 0 and targets[2].sum() > 0
    np.testing.assert_allclose(
        tp.dice_loss(torch.from_numpy(logits[:, :4]), targets).numpy(),
        np.asarray(jp.dice_loss(logits[:, :4], ref_targets)), rtol=1e-6,
        atol=1e-7)
    for dice, focal in ((1.0, 1.0), (0.5, 2.0)):
        got = tp.mask_loss(torch.from_numpy(logits), targets,
                           torch.from_numpy(assign), torch.from_numpy(n),
                           dice, focal)
        want = jp.mask_loss(logits, ref_targets, assign, n, dice, focal)
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_parameter_count_at_the_flagship_config():
    """The 640 flagship's config with the panoptic head at mask size 96:
    the JAX model's 29,118,270 parameters (``jax.eval_shape``)."""
    cfg = dict(image_size=(640, 640), use_pallas_stem=True,
               compute_dtype="bfloat16", max_objects=32, num_categories=82,
               num_attributes=296, backbone="resnet", stem="patchify8")
    model = bt.DETRPanoptic(bt.ModelConfig(**cfg), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 29_118_270
