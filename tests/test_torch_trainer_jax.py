"""The port's ``Trainer.evaluate`` and ``Trainer.predict`` against the JAX
package's ``Trainer`` on the same weights, carried across by
``bridge.load_flax_variables``: the model of tests/test_torch_train.py
(64x64, ResNet patchify8 at width 0.25, 2+2 blocks of width 64, 16
queries, float32) with running statistics that do not amplify rounding
(``_calibrated``), at ``train=False``. The two sides sum in other orders
only; held to 1e-5 (relative for losses, absolute for probabilities and
boxes). The JAX Trainer's programs run under ``jax.jit``, built once for
the module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.models import early_exit
from boosted_detr_torch.train import metrics as tmetrics
from boosted_detr_torch.train.steps import make_predict_step
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.data import codec as jcodec
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.train import metrics as jmetrics
from boosted_detr_tpu.train import trainer as jtrainer
from test_torch_train import B, JAX_CFG, PORT_CFG, _batch, _calibrated

torch.set_num_threads(2)
TOL = 1e-5
VOCAB = {"category": [f"c{i}" for i in range(10)],
         "attribute": [f"a{i}" for i in range(18)]}


def _eval_batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        b = _batch(rng)
        b["orig_size"] = np.tile(np.asarray([[64, 64]], np.int32), (B, 1))
        out.append(b)
    return out


def _perturbed(variables, seed):
    """Every parameter shifted by seeded noise, random running statistics
    (as tests/test_torch_train.py::_variables draws them), from the JAX
    Trainer's own init."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        scale = 0.3 if leaf == "mean" else 0.1
        return a + (rng.standard_normal(a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _threshold(model, image):
    """A confidence threshold between two images' block-0 confidences,
    clear of rounding, so that some images exit at block 0 and some do
    not."""
    outs = make_predict_step(model, return_intermediate=True)(
        torch.from_numpy(image))
    conf = np.sort(early_exit.block_confidence(outs[0]).numpy())
    gaps = np.diff(conf)
    i = int(np.argmax(gaps))
    assert gaps[i] > 1e-4
    return float(conf[i] + gaps[i] / 2)


@pytest.fixture(scope="module")
def trainers():
    batches = _eval_batches()
    image = batches[0]["image"]
    # one JAX init (the Trainer's compile), with the plain stem: the
    # Pallas stem does not run on the CPU outside interpret mode
    jcfg = dataclasses.replace(JAX_CFG, use_pallas_stem=False,
                               early_exit_criterion="confidence")
    ref = jtrainer.Trainer(JaxDETR(jcfg), jcfg,
                           jconfig.TrainConfig(batch_size=B),
                           codec=jcodec.TextCodec(VOCAB))
    ref.compile(sample_batch=batches[0])
    variables = _calibrated(_perturbed(
        {"params": ref.state.params, "batch_stats": ref.state.batch_stats},
        seed=1), image)
    ref.state = ref.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    pcfg = dataclasses.replace(PORT_CFG, early_exit_criterion="confidence")
    model = bt.DETR(pcfg, device="cpu")
    bt.load_flax_variables(model, variables)
    ours = bt.Trainer(model, pcfg, bt.TrainConfig(batch_size=B),
                      codec=TextCodec(VOCAB), device="cpu").compile()
    threshold = _threshold(model, image)
    return {"ours": ours, "batches": batches, "threshold": threshold,
            "evaluate": ref.evaluate(batches),
            "raw": ref.predict(image, decode_text=False),
            "text": ref.predict(image),
            "exit": ref.predict(image, decode_text=False,
                                early_exit_threshold=threshold),
            "map": jmetrics.evaluate_map(ref, batches)}


def test_evaluate_matches_jax(trainers):
    ours = trainers["ours"].evaluate(trainers["batches"])
    ref = trainers["evaluate"]
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, rel=TOL, abs=TOL), k


def test_predict_raw_and_text_match_jax(trainers):
    image = trainers["batches"][0]["image"]
    ours = trainers["ours"].predict(image, decode_text=False)
    ref = trainers["raw"]
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=TOL, err_msg=k)
    cats, atts, boxes = trainers["ours"].predict(image)
    ref_cats, ref_atts, ref_boxes = trainers["text"]
    np.testing.assert_array_equal(cats, ref_cats)
    np.testing.assert_array_equal(atts, ref_atts)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=0, atol=TOL)


def test_early_exit_predict_matches_jax(trainers):
    image = trainers["batches"][0]["image"]
    ours = trainers["ours"].predict(
        image, decode_text=False, early_exit_threshold=trainers["threshold"])
    ref = trainers["exit"]
    np.testing.assert_array_equal(ours["exit_block"], ref["exit_block"])
    assert set(ref["exit_block"].tolist()) == {0, 1}
    for k in ("category", "attribute", "boxes"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_evaluate_map_through_the_trainer_matches_jax(trainers):
    ours = tmetrics.evaluate_map(trainers["ours"], trainers["batches"])
    ref = trainers["map"]
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, rel=TOL, abs=TOL), k
