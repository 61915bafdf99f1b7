"""Small DETRs on the port's new backbones against the JAX package's, on
the CPU, float32, ``train=False``: ``efficientnet_lite`` (the package's
default backbone) and a narrow ``efficientnet_b4``, with their bridge round
trip; ``ModelConfig()``'s defaults built at the JAX parameter count; the
B4's stochastic depth in the train step; and a bf16 smoke test of the B4
backbone. Weights are drawn on the Flax tree's shapes as in
tests/test_torch_norms.py; JAX applies under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tb
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models import backbone as jb
from boosted_detr_tpu.models.boosted import BoostedDETR as JaxBoosted
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from test_torch_norms import F32, _image, _jax, _np, draw

torch.set_num_threads(2)


SMALL = dict(image_size=(64, 64), backbone="efficientnet_lite",
             backbone_width=0.25, num_encoder_blocks=1, num_decoder_blocks=2,
             encoder_dim=32, decoder_dim=32, num_encoder_heads=2,
             num_decoder_heads=2, num_object_preds=8, num_categories=6,
             num_attributes=5, max_objects=4, compute_dtype="float32",
             dropout_rate=0.0)
_DETRS = {}


def _detr_case(backbone):
    """(JAX forward, variables) of a small float32 DETR on ``backbone``."""
    if backbone not in _DETRS:
        image = _image(np.random.default_rng(5))
        jmodel = JaxDETR(jconfig.ModelConfig(**dict(SMALL,
                                                    backbone=backbone)))
        variables = draw(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                        image), np.random.default_rng(6))
        out = jax.jit(jmodel.apply)(_jax(variables), image)
        _DETRS[backbone] = (image, variables,
                            {k: np.asarray(v) for k, v in out.items()})
    return _DETRS[backbone]


@pytest.mark.parametrize("backbone", ["efficientnet_lite", "efficientnet_b4"])
def test_small_detr_matches_jax_and_round_trips(backbone):
    image, variables, ref = _detr_case(backbone)
    model = bt.DETR(bt.ModelConfig(**dict(SMALL, backbone=backbone)),
                    device="cpu").eval()
    bt.load_flax_variables(model, variables)
    with torch.inference_mode():
        out = model(torch.from_numpy(image))
    for k in ("category", "attribute", "boxes"):
        np.testing.assert_allclose(_np(out[k]), ref[k], **F32, err_msg=k)
    # the bridge gives back every leaf bit for bit, the depthwise kernels
    # [kh, kw, 1, C] and the SE convs included
    back = bt.to_flax_layout(model, model.state_dict())
    for collection in ("params", "batch_stats"):
        want = dict(_leaves(variables[collection]))
        ours = dict(_leaves(back[collection]))
        assert set(ours) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(ours[name], w, err_msg=name)
    names = " ".join(dict(_leaves(variables["params"])))
    assert "depthwise/conv/kernel" in names
    if backbone == "efficientnet_b4":
        assert "se/reduce/bias" in names and "se/expand/kernel" in names


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_b4_training_forward_needs_a_generator_and_is_seeded():
    # stochastic depth draws from the step's generator even at dropout 0;
    # the same seed gives the same step, bit for bit
    cfg = bt.ModelConfig(**dict(SMALL, backbone="efficientnet_b4",
                                matcher="pallas"))
    model = bt.DETR(cfg, device="cpu")
    image = torch.from_numpy(_image(np.random.default_rng(7), (4, 64, 64, 3))
                             .clip(0, 1))
    with pytest.raises(ValueError, match="generator"):
        model.train()(image)
    lite = bt.DETR(cfg.replace(backbone="efficientnet_lite"), device="cpu")
    lite.train()(image)  # nothing random: no generator needed
    rng = np.random.default_rng(8)
    batch = {"image": image,
             "category_ids": torch.from_numpy(
                 rng.integers(2, 6, (4, 4)).astype(np.int32)),
             "attribute_ids": torch.from_numpy(
                 rng.integers(0, 5, (4, 4, 2)).astype(np.int32)),
             "bbox": torch.from_numpy(
                 rng.uniform(0.05, 0.45, (4, 4, 4)).astype(np.float32)),
             "num_objects": torch.tensor([1, 4, 2, 3], dtype=torch.int32)}
    start = {k: v.clone() for k, v in model.state_dict().items()}
    results = []
    for seed in (0, 0, 1):
        model.load_state_dict(start)
        tcfg = bt.TrainConfig(batch_size=4, seed=seed)
        state = bt.TrainState.create(model, bt.make_optimizer(
            tcfg, model.parameters(), d_model=32))
        _, aux = bt.make_train_step(model, cfg, tcfg)(state, batch)
        results.append((aux["loss"].item(), {
            k: v.clone() for k, v in model.state_dict().items()}))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        assert torch.equal(results[1][1][k], v), k
    assert results[2][0] != results[0][0]  # another seed, other drops


def test_backbone_bf16_smoke():
    # bfloat16 through the 32 MBConvSE blocks: XLA and torch round the
    # convs, the swish and the squeeze-excite at other places; the map as a
    # whole stays within a few bf16 ulps (2**-8) of relative error
    rng = np.random.default_rng(4)
    image = _image(rng)
    for name in ("efficientnet_b4",):
        jmod = jb.EncoderBackbone(name, 0.25, "batchnorm", jnp.bfloat16)
        variables = draw(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                        image), rng)
        ref = np.asarray(jax.jit(jmod.apply)(_jax(variables), image),
                         np.float32)
        ours = tb.EncoderBackbone(name, 0.25, "batchnorm",
                                  torch.bfloat16).eval()
        bt.load_flax_variables(ours, variables)
        out = ours(torch.from_numpy(image))
        assert out.dtype == torch.bfloat16
        out = _np(out)
        assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 3e-2, name


def test_default_config_builds_with_the_jax_parameter_count():
    # ModelConfig()'s defaults: efficientnet_lite at 560x560, conv7 stem
    # name (unread by the EfficientNet), BatchNorm
    image = jax.ShapeDtypeStruct((1, 560, 560, 3), jnp.float32)
    for jcls, model in ((JaxDETR, bt.DETR(bt.ModelConfig(), device="cpu")),
                        (JaxBoosted, bt.BoostedDETR(bt.ModelConfig(),
                                                    device="cpu"))):
        shapes = jax.eval_shape(jcls(jconfig.ModelConfig()).init,
                                jax.random.PRNGKey(0), image)
        want = {c: sum(int(np.prod(s.shape)) for s in
                       jax.tree_util.tree_leaves(shapes[c]))
                for c in shapes}
        params = sum(p.numel() for p in model.parameters())
        stats = sum(b.numel() for n, b in model.named_buffers()
                    if "running" in n)
        assert (params, stats) == (want["params"], want["batch_stats"])
        assert model.backbone.net_name == "effnet"
