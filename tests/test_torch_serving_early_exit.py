"""The port's early-exit serving artifacts (boosted_detr_torch/serving.py,
``export_serving(..., early_exit=True)``) against the JAX package's on the
CPU, in both criteria, from the same weights: ``BoostedDETR`` at
tests/test_torch_boosted.py::TINY's widths on the ``tiny`` backbone (whose
program exports and loads in half the ResNet's time; the ResNet stem's
artifact is tests/test_torch_serving.py's), weights drawn on
``jax.eval_shape``'s tree and carried across by ``load_flax_variables``.
Each artifact takes its threshold at run time: at the full-depth default
every image exits at the last block, and at a threshold in the widest gap
between the images' block-0 confidences (or block 0 -> 1 deltas) they
split. Exit blocks and strings must be equal, raw outputs within 1e-5
(tests/test_torch_trainer_jax.py's ``TOL``)."""

import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch import serving
from boosted_detr_torch.models import early_exit
from boosted_detr_torch.train.steps import make_predict_step
from boosted_detr_tpu.config import ModelConfig as JaxConfig
from boosted_detr_tpu.models.boosted import BoostedDETR as JaxBoosted
from test_torch_boosted import TINY, tiny_variables
from test_torch_serving import (_close_raw, _images, _jax_artifact,
                                _port_trainer)

torch.set_num_threads(2)
CRITERIA = ("confidence", "stability")
CONFIG = dict(TINY, backbone="tiny", backbone_width=0.25)


def _middle(values):
    """A threshold in the widest gap between per-image values, clear of
    rounding, so that images fall on both sides."""
    v = np.sort(np.asarray(values, np.float64))
    i = int(np.argmax(np.diff(v)))
    assert v[i + 1] - v[i] > 1e-4
    return float(v[i] + (v[i + 1] - v[i]) / 2)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both packages' early-exit artifacts in each criterion, and the
    threshold per criterion that splits the images."""
    tmp = tmp_path_factory.mktemp("early_exit")
    image = _images(0)
    jboosted = JaxBoosted(JaxConfig(**CONFIG))
    variables = tiny_variables(jboosted, image, seed=2)
    trainer = _port_trainer(bt.BoostedDETR, variables, **CONFIG)
    blocks = make_predict_step(trainer.model, return_intermediate=True)(
        torch.from_numpy(image))
    out = {"image": image, "thresholds": {
        "confidence": _middle(early_exit.block_confidence(blocks[0])),
        "stability": _middle(early_exit.prediction_delta(blocks[0],
                                                         blocks[1]))}}
    for c in CRITERIA:
        out["jax", c] = _jax_artifact(jboosted, variables, str(tmp / f"j{c}"),
                                      early_exit=True, exit_criterion=c)
        out["port", c] = serving.load_serving(serving.export_serving(
            trainer, str(tmp / f"p{c}"), platforms="cpu", early_exit=True,
            exit_criterion=c))
    return out


@pytest.mark.parametrize("criterion", CRITERIA)
def test_early_exit_artifacts_match_jax(artifacts, criterion):
    """At the full-depth default (every image exits at the last block) and
    at a threshold that splits the images: exit blocks equal, the outputs
    at each image's exit block within 1e-5, the strings equal, and
    ``exit_block`` carried in the extras slot."""
    ours, ref = artifacts["port", criterion], artifacts["jax", criterion]
    image = artifacts["image"]
    last = TINY["num_decoder_blocks"] - 1
    exits = set()
    for threshold in (None, artifacts["thresholds"][criterion]):
        raw = ours(image, decode_text=False, threshold=threshold)
        ref_raw = ref(image, decode_text=False, threshold=threshold)
        np.testing.assert_array_equal(raw["exit_block"],
                                      ref_raw["exit_block"])
        _close_raw(raw, ref_raw)
        if threshold is None:
            assert (raw["exit_block"] == last).all()
        else:
            exits = set(raw["exit_block"].tolist())
        cats, atts, _, extras = ours(image, threshold=threshold)
        ref_cats, ref_atts, _, ref_extras = ref(image, threshold=threshold)
        np.testing.assert_array_equal(cats, ref_cats)
        np.testing.assert_array_equal(atts, ref_atts)
        np.testing.assert_array_equal(extras["exit_block"],
                                      ref_extras["exit_block"])
    assert len(exits) > 1, exits
