"""The port's user-facing API (boosted_detr_torch/api.py) against the JAX
package's (boosted_detr_tpu/api.py) on the CPU: ``api.DETR`` and
``api.BoostedDETR`` built with the same keywords (tests/
test_torch_boosted.py::TINY's widths on the ``tiny`` backbone, float32),
compiled on both sides, the JAX model's weights drawn on its tree
(``tiny_variables``) and carried to the port by ``load_flax_variables``;
``__call__`` gives equal strings and probabilities and boxes within 1e-5
(tests/test_torch_trainer_jax.py's ``TOL``), ``get_config`` is JAX's.
Then the port alone: ``save`` and ``load_model`` bit for bit (the EMA
shadow and a panoptic mask size included), the loss-weight precedence of
``compile``, ``DETR_MultiClassifier.transfer_to_base`` (the trunk moves,
nothing else), and the constructors' default device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch import api
from boosted_detr_torch.config import LossWeights, TrainConfig
from boosted_detr_tpu import api as japi
from test_torch_boosted import TINY, tiny_variables

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = {"category": ["c0", "c1", "c2", "c3"], "attribute": ["a0", "a1"]}
# the constructor's keywords: TINY without the vocabulary sizes, which the
# API takes from the codec
KW = {k: v for k, v in dict(TINY, backbone="tiny", backbone_width=0.25)
      .items() if k not in ("num_categories", "num_attributes")}
B = 4
CLASSES = ("DETR", "BoostedDETR")


def _images(seed, b=B):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (b, 64, 64, 3)).astype(np.float32)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": _images(seed),
            "category_ids": rng.integers(2, 6, (B, 3)).astype(np.int32),
            "attribute_ids": rng.integers(0, 4, (B, 3, 2)).astype(np.int32),
            "bbox": rng.uniform(0.05, 0.45, (B, 3, 4)).astype(np.float32),
            "num_objects": rng.integers(1, 4, (B,)).astype(np.int32)}


def _port(name, **kw):
    model = getattr(api, name)(vocab_dict=VOCAB, device="cpu",
                               **dict(KW, **kw))
    model.compile(sample_batch={"image": _images(0)})
    return model


@pytest.fixture(scope="module")
def reference():
    """Each class compiled on both sides with the same weights, and JAX's
    text and raw outputs on one batch."""
    image = _images(1)
    out = {"image": image}
    for i, name in enumerate(CLASSES):
        jmodel = getattr(japi, name)(vocab_dict=VOCAB, **KW)
        jmodel.compile(sample_batch={"image": image})
        variables = tiny_variables(jmodel.module, image, seed=i + 1)
        jmodel.trainer.state = jmodel.trainer.state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]))
        ours = _port(name)
        bt.load_flax_variables(ours.module, variables)
        out[name] = {"jax": jmodel, "ours": ours,
                     "text": jmodel({"image": image}),
                     "raw": jmodel(image, training=True)}
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_call_matches_jax(reference, name):
    ref, ours = reference[name], reference[name]["ours"]
    image = reference["image"]
    raw = ours(image, training=True)
    assert raw.keys() == ref["raw"].keys()
    for k, v in ref["raw"].items():
        np.testing.assert_allclose(raw[k], np.asarray(v), rtol=0, atol=TOL,
                                   err_msg=k)
    cats, atts, boxes = ours({"image": image})
    ref_cats, ref_atts, ref_boxes = ref["text"]
    np.testing.assert_array_equal(cats, ref_cats)
    np.testing.assert_array_equal(atts, ref_atts)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", CLASSES)
def test_get_config_and_compile_match_jax(reference, name):
    jmodel, ours = reference[name]["jax"], reference[name]["ours"]
    assert ours.get_config() == jmodel.get_config()
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(
        jmodel.config)
    # compile's train config, the loss weights and the boosted ensemble's
    # intermediate losses included
    assert (dataclasses.asdict(ours.trainer.train_cfg)
            == dataclasses.asdict(jmodel.trainer.train_cfg))


def test_compile_keeps_the_loss_weight_precedence():
    """An explicit ``loss_weights`` keyword over an explicit non-default
    ``train_config.loss_weights`` over the constructor's (attribute_weight,
    classification_only), as JAX's compile (api.py:91-112)."""
    model = _port("DETR", attribute_weight=0.5, classification_only=True)
    derived = LossWeights(attribute=50.0, box=0.0)
    assert model.loss_weights == derived
    assert model.trainer.train_cfg.loss_weights == derived
    chosen = LossWeights(category=7.0)
    model.compile(sample_batch={"image": _images(0)},
                  train_config=TrainConfig(loss_weights=chosen))
    assert model.trainer.train_cfg.loss_weights == chosen
    explicit = LossWeights(exist=3.0)
    model.compile(sample_batch={"image": _images(0)},
                  train_config=TrainConfig(loss_weights=chosen),
                  loss_weights=explicit)
    assert model.trainer.train_cfg.loss_weights == explicit
    boosted = _port("BoostedDETR")
    assert boosted.trainer.train_cfg.use_intermediate_losses


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_save_and_load_model_round_trip_bit_for_bit(tmp_path):
    """A fitted DETR with an EMA shadow: weights, running statistics, the
    shadow, loss weights and config come back bit for bit, and so do the
    outputs; a DETRPanoptic keeps its mask size."""
    model = _port("DETR", attribute_weight=2.0)
    model.compile(sample_batch={"image": _images(0)},
                  train_config=TrainConfig(ema_decay=0.5, optimizer="adamw",
                                           lr_schedule="constant",
                                           clipnorm=0.0))
    history = model.fit([_batch(2), _batch(3)])
    assert np.isfinite(history["loss"]).all()
    assert np.isfinite(model.evaluate([_batch(4)])["loss"])
    model.save(str(tmp_path / "detr"))
    loaded = api.load_model(str(tmp_path / "detr"), device="cpu")
    assert type(loaded) is api.DETR and loaded.device.type == "cpu"
    _same(loaded.module, model.module)
    ema, want = loaded.trainer.state.ema_params, model.trainer.state.ema_params
    assert ema.keys() == want.keys()
    assert all(torch.equal(ema[k], want[k]) for k in want)
    assert not all(torch.equal(want[k], p) for k, p in
                   model.module.named_parameters())  # the shadow lags
    assert loaded.loss_weights == model.loss_weights
    assert loaded.get_config() == model.get_config()
    assert loaded.config == model.config
    image = _images(5)
    for k, v in model(image, training=True).items():
        np.testing.assert_array_equal(loaded(image, training=True)[k], v)

    panoptic = _port("DETRPanoptic", mask_size=16)
    panoptic.save(str(tmp_path / "panoptic"))
    back = api.load_model(str(tmp_path / "panoptic"), device="cpu")
    assert type(back) is api.DETRPanoptic and back.module.mask_size == 16
    assert back.make_pipeline().mask_size == 16
    _same(back.module, panoptic.module)


def test_transfer_to_base_moves_the_trunk_and_nothing_else():
    base = _port("DETR")
    clf = api.DETR_MultiClassifier(base, VOCAB, hidden_dim=32)
    clf.compile(sample_batch={"image": _images(0)})
    history = clf.fit([_batch(6)], epochs=1)
    assert np.isfinite(history).all()
    before = {k: v.clone() for k, v in base.module.state_dict().items()}
    trunk = clf.module.detr.state_dict()
    clf.transfer_to_base()
    after = base.module.state_dict()
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved and moved <= set(trunk)  # the trunk trained, and moved
    for k, v in after.items():
        if k in trunk:
            assert torch.equal(v, trunk[k]), k  # every trunk entry copied
        else:
            assert torch.equal(v, before[k]), k  # the heads stay the base's
    assert any(k.startswith("category_head") for k in after)


def test_constructors_and_load_model_default_to_cuda(monkeypatch, tmp_path):
    """No ``device`` means cuda: without a card that raises instead of
    running on the CPU."""
    model = _port("DETR")
    model.save(str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: api.DETR(vocab_dict=VOCAB, **KW),
                 lambda: api.load_model(str(tmp_path / "m"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="vocab_dict"):
        api.DETR(**KW)
