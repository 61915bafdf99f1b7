"""The port's ViT backbone (boosted_detr_torch/models/backbone.py:
``ViTBlock``, ``ViTBackbone``, ``parse_vit_spec`` and the ``vit`` routes of
``EncoderBackbone``) in a small DETR against the JAX package's, on the CPU,
with the patch embed through the patchify kernel's route and the blocks
through the fused attention's (the JAX side's Pallas kernels in interpret
mode), and the bridge of the ViT's leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tb
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models import backbone as jb
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.ops import pallas_attention as jpa

torch.set_num_threads(2)

# float32 compute: the sides differ by float32 sum order through the
# blocks; measured under 2e-6 on outputs of unit scale, held to 1e-5.
F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX MHA's fused route through the Pallas kernel's interpreter
    (layers.py:106 imports ``fused_attention`` at call time)."""
    kernel = jpa.fused_attention
    monkeypatch.setattr(jpa, "fused_attention",
                        lambda *a, **kw: kernel(*a, interpret=True))


def _np(t):
    return t.detach().float().numpy()


def _close(ours, ref, tol, what=""):
    np.testing.assert_allclose(_np(ours), np.asarray(ref, np.float32),
                               err_msg=what, **tol)


def _perturbed(variables, rng, noise=0.1):
    """Flax variables -> nested numpy dicts, every leaf shifted by seeded
    noise."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + (rng.standard_normal(np.shape(a)) * noise).astype(np.float32),
        variables)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_trees_close(ours, ref, rel, floor, what):
    """Per leaf: ||ours - ref|| <= rel ||ref leaf|| + floor ||ref tree||."""
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    total = np.sqrt(sum(np.sum(np.square(r)) for r in ref.values()))
    for name, r in ref.items():
        err = np.linalg.norm(ours[name] - r)
        bound = rel * np.linalg.norm(r) + floor * total
        assert err <= bound, f"{what} {name}: {err:.3e} over {bound:.3e}"


def test_parse_vit_spec_is_the_jax_one():
    for name in ("vit", "vit_p32", "vit_p16_d2_w64_h2", "vit_p8_d3_w96_h3_qk",
                 "vit_qk_h12"):
        for width in (1.0, 0.5):
            assert (tb.parse_vit_spec(name, width)
                    == jb.parse_vit_spec(name, width))
    for bad in ("vit_x3", "vit_p", "vit_pq"):
        with pytest.raises(ValueError, match="bad vit spec"):
            tb.parse_vit_spec(bad, 1.0)


_VIT = dict(image_size=(64, 64), num_encoder_blocks=1, num_decoder_blocks=2,
            num_encoder_heads=2, num_decoder_heads=2, encoder_dim=64,
            decoder_dim=64, num_object_preds=8, num_categories=7,
            num_attributes=8, compute_dtype="float32")


@pytest.mark.parametrize("backbone,pallas_stem,pallas_attention", [
    ("vit_p16_d2_w64_h2", True, True),    # K1 with its bias, K3 throughout
    ("vit_p16_d2_w64_h2_qk", True, True),  # with the QK-norm
    ("vit_p16_d2_w64_h2_qk", False, False),  # the plain ViT route
    # head dims over 64: ViT-Huge's D = 80 and D = 128, both as built on
    # the card
    ("vit_p16_d2_w160_h2", True, True),
    ("vit_p16_d2_w256_h2", True, True),
])
def test_small_vit_detr_matches_jax(interpret, backbone, pallas_stem,
                                    pallas_attention):
    """A 64x64 ViT DETR (patch 16: 4x4 tokens of width 64, 160 or 256, 2
    heads, reduced to the 2x2 grid at width 128): the eval forward and the
    gradient of a fixed linear function of its outputs at the frozen
    running statistics, leaf by leaf."""
    cfg = dict(_VIT, backbone=backbone, use_pallas_stem=pallas_stem,
               use_pallas_attention=pallas_attention)
    rng = np.random.default_rng(6)
    image = rng.uniform(-0.05, 1.05, (2, 64, 64, 3)).astype(np.float32)
    jmodel = JaxDETR(jconfig.ModelConfig(**cfg))
    init = jax.jit(JaxDETR(jconfig.ModelConfig(**dict(
        cfg, use_pallas_attention=False))).init)  # the same tree
    variables = _perturbed(init(jax.random.PRNGKey(0), image), rng)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    weights = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("category", (2, 8, 7)), ("attribute", (2, 8, 8)),
        ("boxes", (2, 8, 4)))}

    def j_loss(params):
        out = jmodel.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, image)
        return sum(jnp.sum(out[k] * weights[k]) for k in weights), out

    (_, ref), j_grads = jax.block_until_ready(jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(_jax(variables["params"])))

    model = bt.DETR(bt.ModelConfig(**cfg), device="cpu").eval()
    bt.load_flax_variables(model, variables)
    assert model.backbone.fused == pallas_stem
    out = model(torch.from_numpy(image))
    for key in ("category", "attribute", "boxes"):
        _close(out[key], ref[key], F32, key)
    sum((out[k] * torch.from_numpy(w)).sum()
        for k, w in weights.items()).backward()
    grads = bt.to_flax_layout(model, {n: p.grad for n, p in
                                      model.named_parameters()})["params"]
    # sum order only (float32): measured under 1e-5 of each leaf
    _assert_trees_close(grads, jax.tree_util.tree_map(np.asarray, j_grads),
                        1e-4, 1e-6, "grad")


def test_vit_leaves_bridge_both_ways():
    cfg = dict(_VIT, backbone="vit_p16_d2_w64_h2_qk", use_pallas_stem=True,
               use_pallas_attention=True)
    image = np.zeros((1, 64, 64, 3), np.float32)
    variables = jax.jit(JaxDETR(jconfig.ModelConfig(**dict(
        cfg, use_pallas_attention=False))).init)(jax.random.PRNGKey(0),
                                                 image)
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(  # distinct values everywhere
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        variables)
    model = bt.DETR(bt.ModelConfig(**cfg), device="cpu")
    bt.load_flax_variables(model, variables)
    state = model.state_dict()
    vit = variables["params"]["backbone"]["vit"]
    assert set(vit) == {"patch_embed", "positional_embedding", "block_0",
                        "block_1", "ln_final", "reduce"}
    assert set(vit["block_0"]) == {"ln1", "ln2", "attn", "mlp_in", "mlp_out"}
    np.testing.assert_array_equal(
        state["backbone.vit.block_1.attn.q_norm.weight"].numpy(),
        vit["block_1"]["attn"]["q_norm"]["scale"])
    assert "backbone.vit.block_1.attn.q_norm.bias" not in state
    np.testing.assert_array_equal(
        state["backbone.vit.patch_embed.bias"].numpy(),
        vit["patch_embed"]["bias"])
    np.testing.assert_array_equal(
        state["backbone.vit.patch_embed.weight"].numpy(),
        vit["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    back = bt.to_flax_layout(model, state)
    for collection in ("params", "batch_stats"):
        ours = dict(_leaves(back[collection]))
        ref = dict(_leaves(jax.tree_util.tree_map(
            np.asarray, variables[collection])))
        assert set(ours) == set(ref), set(ours) ^ set(ref)
        for name, r in ref.items():
            np.testing.assert_array_equal(ours[name], r, err_msg=name)


def test_unported_backbones_still_raise():
    # every backbone name JAX's EncoderBackbone knows builds now; a name
    # that is not one (exact-prefix match: "vitp32" is no ViT) raises
    # ValueError, as JAX's does
    for name, net in (("efficientnet_lite", "effnet"), ("tiny", "tiny")):
        assert tb.EncoderBackbone(name, image_size=(64, 64)).net_name == net
    with pytest.raises(ValueError, match="unknown backbone 'vitp32'"):
        tb.EncoderBackbone("vitp32", image_size=(64, 64))
    with pytest.raises(ValueError, match="image_size"):
        tb.EncoderBackbone("vit")
