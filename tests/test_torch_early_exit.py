"""The port's early-exit inference (boosted_detr_torch.models.early_exit and
``predict(..., early_exit_threshold=...)``) on the CPU: each function
against the JAX package's on the same arrays, the selections on a boosted
model's cumulative outputs, and the incremental predictors of the boosted
ensemble and of DETR against their full forwards, as
tests/test_panoptic_early_exit.py holds the JAX ones; the boosted one in
every query mode also against JAX's ``BoostedDETR.__call__`` with the
same weights (not against JAX's incremental function, which computes
another model in those modes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.models import early_exit as tee
from boosted_detr_tpu.config import ModelConfig as JaxConfig
from boosted_detr_tpu.models import early_exit as jee
from boosted_detr_tpu.models.boosted import BoostedDETR as JaxBoosted
from test_torch_boosted import TINY, tiny_variables
from test_torch_boosted import _image as _boosted_image

torch.set_num_threads(2)

N, B, P, V = 4, 6, 8, 5
F32 = dict(atol=1e-6, rtol=1e-6)


def _outputs(seed):
    """N blocks of cumulative boosted-like outputs: block k's category is a
    sum of k + 1 softmaxes (some slots sure of PAD, some of a class, some
    undecided), boxes drift by a shrinking step, so that confidences and
    deltas spread across images and blocks."""
    rng = np.random.default_rng(seed)
    outs, cat, box = [], 0.0, rng.uniform(0, 1, (B, P, 4))
    for k in range(N):
        logits = (rng.standard_normal((B, P, V))
                  * rng.uniform(0.5, 4, (B, 1, 1)))
        soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        cat = cat + soft
        box = box + rng.standard_normal((B, P, 4)) * 0.2 / (k + 1) ** 2
        outs.append({"category": cat.astype(np.float32),
                     "attribute": rng.uniform(0, 1, (B, P, 3)).astype(
                         np.float32),
                     "boxes": box.astype(np.float32)})
    return outs


def _torch(outs):
    return [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs]


def _jax(outs):
    return [{k: jnp.asarray(v) for k, v in o.items()} for o in outs]


def _close(ours, theirs, **tol):
    if isinstance(ours, dict):
        assert set(ours) == set(theirs)
        for k in theirs:
            _close(ours[k], theirs[k], **tol)
        return
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               **(tol or F32))


@pytest.mark.parametrize("pad_id", [0, 2])
def test_block_confidence_and_delta_match_jax(pad_id):
    outs = _outputs(0)
    t, j = _torch(outs), _jax(outs)
    for k in range(N):
        _close(tee.block_confidence(t[k], pad_id),
               jee.block_confidence(j[k], pad_id))
    for k in range(1, N):
        _close(tee.prediction_delta(t[k - 1], t[k], pad_id),
               jee.prediction_delta(j[k - 1], j[k], pad_id))
    # an image whose every slot is certain-PAD: confidence 1, delta 0
    sure = {"category": torch.zeros(1, P, V), "boxes": torch.zeros(1, P, 4)}
    sure["category"][..., pad_id] = 1.0
    assert tee.block_confidence(sure, pad_id).item() == 1.0
    assert tee.prediction_delta(sure, sure, pad_id).item() == 0.0


def test_normalize_and_gather_match_jax():
    outs = _outputs(1)
    t, j = _torch(outs), _jax(outs)
    _close(tee._normalize_category(t[2]), jee._normalize_category(j[2]))
    exit_block = np.array([0, 3, 1, 2, 3, 0], np.int32)
    _close(tee._gather_at(t, torch.from_numpy(exit_block)),
           jee._gather_at(j, jnp.asarray(exit_block)))


@pytest.mark.parametrize("threshold", [0.3, 0.6, 0.9, 1.1])
def test_adaptive_select_matches_jax(threshold):
    outs = _outputs(2)
    preds, exit_block = tee.adaptive_select(_torch(outs), threshold)
    want, want_exit = jee.adaptive_select(_jax(outs), threshold)
    np.testing.assert_array_equal(exit_block.numpy(), np.asarray(want_exit))
    assert exit_block.dtype == torch.int32
    _close(preds, want)


@pytest.mark.parametrize("tau", [0.0, 0.2, 0.5, 10.0])
def test_stability_select_matches_jax(tau):
    outs = _outputs(3)
    preds, exit_block = tee.stability_select(_torch(outs), tau)
    want, want_exit = jee.stability_select(_jax(outs), tau)
    np.testing.assert_array_equal(exit_block.numpy(), np.asarray(want_exit))
    _close(preds, want)
    one, one_exit = tee.stability_select(_torch(outs[:1]), tau)
    jone, jone_exit = jee.stability_select(_jax(outs[:1]), tau)
    np.testing.assert_array_equal(one_exit.numpy(), np.asarray(jone_exit))
    _close(one, jone)


def test_selections_spread_the_exits():
    """The thresholds above reach mixed-depth batches, so that the per-image
    gather is exercised."""
    assert len(set(tee.adaptive_select(_torch(_outputs(2)), 0.6)[1]
                   .tolist())) > 1
    assert len(set(tee.stability_select(_torch(_outputs(3)), 0.2)[1]
                   .tolist())) > 1


@pytest.mark.parametrize("criterion", ["confidence", "stability"])
def test_stop_check_matches_jax(criterion):
    outs = _outputs(4)
    t, j = _torch(outs), _jax(outs)
    for threshold in (0.05, 0.5, 0.95):
        ours = tee._make_stop_check(threshold, criterion)
        theirs = jee._make_stop_check(threshold, criterion)
        for k in range(N):
            prev_t, prev_j = (t[k - 1], j[k - 1]) if k else (None, None)
            assert ours(prev_t, t[k]) == theirs(prev_j, j[k])
    with pytest.raises(ValueError, match="criterion"):
        tee._make_stop_check(0.5, "entropy")


def _boosted(seed=0, **kw):
    model = bt.BoostedDETR(bt.ModelConfig(**dict(TINY, **kw)), device="cpu",
                           seed=seed).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
    return model


def _images(seed, b=3):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("select", ["adaptive", "stability"])
def test_selections_on_boosted_cumulative_outputs(select):
    """Over a boosted model's cumulative sums the port and JAX select the
    same exits and outputs; the category comes back a distribution."""
    model = _boosted()
    with torch.inference_mode():
        outs = model(torch.from_numpy(_images(5)), return_intermediate=True)
    arrays = [{k: v.numpy() for k, v in o.items()} for o in outs]
    sums = [o["category"].sum(-1).mean() for o in arrays]
    np.testing.assert_allclose(sums, [1.0, 2.0, 3.0], rtol=1e-5)
    # the adaptive threshold halfway between two middle confidences, clear
    # of each side's rounding
    confs = torch.stack([tee.block_confidence(o) for o in outs]).flatten()
    lo, hi = confs.sort().values[len(confs) // 2 - 1:len(confs) // 2 + 1]
    assert hi - lo > 1e-4
    threshold = float(lo + hi) / 2 if select == "adaptive" else 0.5
    ours = getattr(tee, f"{select}_select")(outs, threshold)
    theirs = getattr(jee, f"{select}_select")(_jax(arrays), threshold)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    _close(ours[0], theirs[0])
    np.testing.assert_allclose(ours[0]["category"].sum(-1).numpy(), 1.0,
                               atol=1e-5)


def _full(model, image):
    with torch.inference_mode():
        out = model(image)
    return {k: v.numpy() for k, v in out.items()}


def _check_against_full(preds, full):
    for key in ("boxes", "attribute"):
        np.testing.assert_allclose(preds[key].numpy(), full[key], atol=1e-5,
                                   rtol=0, err_msg=key)
    cat = full["category"].astype(np.float64)
    np.testing.assert_allclose(preds["category"].numpy(),
                               cat / cat.sum(-1, keepdims=True), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("double_count", [False, True])
def test_incremental_boosted_matches_the_full_forward(double_count):
    model = _boosted(block0_double_count=double_count).train()
    image = torch.from_numpy(_images(6))
    predict = tee.make_incremental_predict(model, threshold=1.1)
    preds, blocks_run = predict(image)
    assert blocks_run == TINY["num_decoder_blocks"]
    assert model.training  # the mode it found is back
    _check_against_full(preds, _full(model.eval(), image))
    preds0, blocks_run0 = tee.make_incremental_predict(model, 0.0)(image)
    assert blocks_run0 == 1
    with model.focused(0):
        _check_against_full(preds0, _full(model, image))
    # stability: never at the first block; a huge tau stops at the second
    _, runs = tee.make_incremental_predict(model, 1e9, "stability")(image)
    assert runs == 2


def _detr():
    cfg = bt.ModelConfig(**dict(TINY, num_encoder_blocks=1))
    model = bt.DETR(cfg, device="cpu", seed=3).eval()
    return model


def test_incremental_detr_matches_the_full_forward():
    model = _detr()
    image = torch.from_numpy(_images(7))
    preds, blocks_run = tee.make_incremental_predict(model, 1.1)(image)
    assert blocks_run == TINY["num_decoder_blocks"]
    _check_against_full(preds, _full(model, image))
    preds0, blocks_run0 = tee.make_incremental_predict(model, 0.0)(image)
    assert blocks_run0 == 1
    with torch.inference_mode():
        first = model(image, return_intermediate=True)[0]
    _check_against_full(preds0, {k: v.numpy() for k, v in first.items()})


# The modes the incremental boosted predictor runs beside fresh queries:
# (config keywords, focused_training_layer). Confidence at 0.5 freezes some
# slots and not others on these weights and images
# (tests/test_torch_boosted.py::test_confidence_thresholds_are_clear_of_rounding).
MODES = {
    "carry": (dict(boosted_queries="carry"), None),
    "carry_double_count": (dict(boosted_queries="carry",
                                block0_double_count=True), None),
    "confidence": (dict(boosted_queries="confidence",
                        boosted_carry_threshold=0.5), None),
    "shared_encoder": (dict(boosted_shared_encoder=True), None),
    "focused_1": ({}, 1),
}
# (threshold, criterion, blocks run without a focused layer): confidence
# 1.1, which no image reaches, runs every block; stability at a huge tau
# stops at the first block it may, the second.
STOPS = {"every_block": (1.1, "confidence", TINY["num_decoder_blocks"]),
         "early": (1e9, "stability", 2)}


@pytest.fixture(scope="module")
def mode_reference():
    """JAX's ``BoostedDETR.__call__(return_intermediate=True)`` in each
    mode, without its focused layer (the forward it is held to), on
    weights drawn as tests/test_torch_boosted.py draws them (one tree for
    the per-block encoders, one for the shared encoder)."""
    image = _boosted_image(0)
    trees, outs = {}, {}
    for name, (kw, _) in MODES.items():
        jmodel = JaxBoosted(JaxConfig(**dict(TINY, **kw)))
        shared = kw.get("boosted_shared_encoder", False)
        if shared not in trees:
            trees[shared] = tiny_variables(jmodel, image, seed=1 + shared)
        outs[name] = [{k: np.asarray(v, np.float32) for k, v in o.items()}
                      for o in jmodel.apply(trees[shared], image,
                                            return_intermediate=True)]
    return {"image": image, "trees": trees, "outs": outs}


@pytest.mark.parametrize("stop", list(STOPS))
@pytest.mark.parametrize("mode", list(MODES))
def test_incremental_boosted_matches_jax_in_every_mode(mode_reference, mode,
                                                       stop):
    """Carried queries (with and without block 0 counted twice), the
    confidence freeze, one shared encoder and a focused training layer:
    the incremental predictor's output at its exit block against the
    port's ``return_intermediate`` output there and against JAX's
    ``BoostedDETR.__call__`` with the same weights (float32, 1e-5). A
    focused layer ends the loop at its block, whose output is the
    unfocused model's there."""
    kw, focused = MODES[mode]
    threshold, criterion, runs = STOPS[stop]
    if focused is not None:
        runs = min(runs, focused + 1)
    model = bt.BoostedDETR(bt.ModelConfig(**dict(TINY, **kw)), device="cpu",
                           focused_training_layer=focused).eval()
    bt.load_flax_variables(model, mode_reference["trees"][
        kw.get("boosted_shared_encoder", False)])
    image = torch.from_numpy(mode_reference["image"])
    preds, blocks_run = tee.make_incremental_predict(model, threshold,
                                                     criterion)(image)
    assert blocks_run == runs
    with torch.inference_mode(), model.focused(None):
        port = model(image, return_intermediate=True)[blocks_run - 1]
    for want in ({k: v.numpy() for k, v in port.items()},
                 mode_reference["outs"][mode][blocks_run - 1]):
        _check_against_full(preds, want)


@pytest.mark.parametrize("criterion", ["stability", "confidence"])
def test_predict_with_early_exit_returns_exit_block(criterion):
    model = _boosted(early_exit_criterion=criterion)
    images = _images(8, b=4)
    threshold = 0.5
    raw = bt.predict(model, images, decode_text=False,
                     early_exit_threshold=threshold)
    assert set(raw) == {"category", "attribute", "boxes", "exit_block"}
    with torch.inference_mode():
        outs = model(torch.from_numpy(images), return_intermediate=True)
    select = (jee.stability_select if criterion == "stability"
              else jee.adaptive_select)
    want, want_exit = select(_jax([{k: v.numpy() for k, v in o.items()}
                                   for o in outs]), threshold)
    np.testing.assert_array_equal(raw["exit_block"], np.asarray(want_exit))
    for key in ("category", "attribute", "boxes"):
        np.testing.assert_allclose(raw[key], np.asarray(want[key]), **F32)
    # the config's threshold when none is given; none at all: the plain
    # forward
    configured = bt.BoostedDETR(
        model.config.replace(early_exit_threshold=threshold), device="cpu")
    configured.load_state_dict(model.state_dict())
    again = bt.predict(configured, images, decode_text=False)
    np.testing.assert_array_equal(again["exit_block"], raw["exit_block"])
    plain = bt.predict(model, images, decode_text=False)
    assert "exit_block" not in plain
    codec = TextCodec({"category": ["a", "b", "c", "d"],
                       "attribute": ["x", "y"]})
    cats, atts, boxes = bt.predict(model, images, codec,
                                   early_exit_threshold=threshold)
    assert cats.shape == atts.shape == (4, TINY["num_object_preds"])
    np.testing.assert_array_equal(boxes, raw["boxes"])
