"""The port's classifier pre-trainer (boosted_detr_torch/models/
pretrainer.py) against the JAX package's on the CPU: ``DETRMultiClassifier``'s
forward at ``return_intermediate`` both ways (float32, and a bf16 smoke
test), ``pretrain_loss``, one ``make_pretrain_step`` step (live BatchNorm:
tests/test_torch_train.py's ``live`` tolerances) and the loss's gradients
at ``train=False`` from calibrated running statistics (the ``frozen``
ones: JAX's pre-train step has no ``freeze_bn_stats``),
``transfer_to_detr`` and ``load_from_detr`` against JAX's tree surgery,
the bridge over the pre-trainer's tree (``detr/<trunk>`` and
``classifier_head``, no head leaves) and the parameter count at the 640
flagship's config. The model is tests/test_torch_boosted.py's TINY with 2
decoder blocks and 6 classifier classes; JAX runs under ``jax.jit``.
Dropout is 0: the sides cannot draw the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tbackbone
from boosted_detr_torch.models import pretrainer as tpre
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models import pretrainer as jpre
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.train import steps as jsteps
from test_torch_boosted import TINY, tiny_variables
from test_torch_boosted_train import _to_np
from test_torch_train import STEP_TOL, _assert_trees_close, _capture_raw_grads

torch.set_num_threads(2)

CFG = dict(TINY, num_decoder_blocks=2)
CLASSES = 6
B, O = 8, 3
# float32: sums in other orders through the trunk; measured within 4e-7
F32 = dict(atol=1e-5, rtol=1e-5)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, CLASSES, (B, O)).astype(np.int32)
    ids[0, 1:] = 0  # padded rows: <PAD> one-hot, as JAX's loss takes them
    ids[1, 2] = CLASSES + 3  # outside the vocabulary: a zero row
    return {"image": rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
            "category_ids": ids}


def _port(variables, **kw):
    model = tpre.DETRMultiClassifier(bt.ModelConfig(**dict(CFG, **kw)),
                                     CLASSES, device="cpu")
    bt.load_flax_variables(model, variables)
    return model


def _calibrated(variables, image):
    """Running statistics that normalise ``image`` without amplifying, as
    tests/test_torch_train.py::_calibrated makes them."""
    model = _port(variables).train()
    for m in model.modules():
        if isinstance(m, tbackbone.BatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        model(torch.from_numpy(image))
    stats = {k: v + 1.0 if k.endswith("running_var") else v
             for k, v in model.state_dict().items() if "running" in k}
    return dict(variables,
                batch_stats=bt.to_flax_layout(model, stats)["batch_stats"])


@pytest.fixture(scope="module")
def reference():
    batch = _batch(0)
    jmodel = jpre.DETRMultiClassifier(jconfig.ModelConfig(**CFG), CLASSES)
    variables = tiny_variables(jmodel, batch["image"], seed=6)
    image = batch["image"]
    ref = {"batch": batch, "variables": variables, "jmodel": jmodel}
    outs = jax.jit(lambda v, x: jmodel.apply(
        v, x, return_intermediate=True))(variables, image)
    ref["outs"] = [np.asarray(o) for o in outs]
    # the live step
    tcfg = jconfig.TrainConfig(batch_size=B)
    svars = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = optax.chain(_capture_raw_grads(), jsteps.make_optimizer(
        tcfg, d_model=CFG["decoder_dim"]))
    state = jsteps.TrainState.create(svars["params"], svars["batch_stats"],
                                     tx)
    new, metrics = jax.jit(jpre.make_pretrain_step(jmodel))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(2))
    ref["live"] = {"metrics": _to_np(metrics),
                   "grads": _to_np(new.opt_state[0]),
                   "params": _to_np(new.params),
                   "batch_stats": _to_np(new.batch_stats)}
    # the frozen regime: the loss at train=False and its gradients
    frozen = _calibrated(variables, image)

    def loss(params):
        outs = jmodel.apply({"params": params,
                             "batch_stats": frozen["batch_stats"]}, image,
                            return_intermediate=True)
        m = jpre.pretrain_loss(outs, jnp.asarray(batch["category_ids"]),
                               CLASSES)
        return m["loss"], m

    (total, metrics), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                    frozen["params"]))
    ref["frozen"] = {"variables": frozen, "loss": float(total),
                     "accuracy": float(metrics["accuracy"]),
                     "grads": _to_np(grads)}
    return ref


@pytest.mark.parametrize("intermediate", [True, False])
def test_forward_matches_jax(reference, intermediate):
    model = _port(reference["variables"]).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(reference["batch"]["image"]),
                    return_intermediate=intermediate)
    ref = reference["outs"]
    if not intermediate:  # JAX's final output is its last block's
        out, ref = [out], ref[-1:]
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == (B, 1, CLASSES) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, **F32)


def test_the_trunk_has_no_head_leaves_and_bridges_both_ways(reference):
    """The pre-trainer's ``detr`` subtree holds the trunk alone (Flax never
    creates the unused heads' leaves): every leaf of JAX's tree fills one
    entry of the port's and back."""
    model = _port(reference["variables"])
    names = set(model.state_dict())
    assert not any(k.startswith(("detr.category_head", "detr.attribute_head",
                                 "detr.box_head")) for k in names)
    back = bt.to_flax_layout(model, model.state_dict())
    for coll in ("params", "batch_stats"):
        _assert_trees_close(back[coll], reference["variables"][coll], 0.0,
                            coll)


def test_pretrain_loss_matches_jax():
    """Every row of ``category_ids`` one-hot, padded rows included; ids
    outside the vocabulary give a zero row; the focal loss summed over the
    classes, its least over the singleton axis, summed over the blocks and
    the batch."""
    rng = np.random.default_rng(1)
    preds = [rng.uniform(0.01, 0.99, (B, 1, CLASSES)).astype(np.float32)
             for _ in range(3)]
    ids = _batch(1)["category_ids"]
    got = tpre.pretrain_loss([torch.from_numpy(p) for p in preds],
                             torch.from_numpy(ids), CLASSES)
    want = jpre.pretrain_loss([jnp.asarray(p) for p in preds],
                              jnp.asarray(ids), CLASSES)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_pretrain_step_matches_jax(reference, monkeypatch):
    """One pre-training step with live BatchNorm (always intermediate; SGD,
    Nesterov, clipnorm 0.1, cosine restarts): the loss and accuracy, the
    raw gradients, the new parameters and running statistics, at the
    ``live`` tolerances."""
    tol = STEP_TOL["live"]
    ref = reference["live"]
    model = _port(reference["variables"])
    raw = {}
    clip = tsteps.clip_by_per_variable_norm

    def capture(grads, max_norm):
        raw.update({name: p.grad.clone()
                    for name, p in model.named_parameters()})
        clip(grads, max_norm)

    monkeypatch.setattr(tsteps, "clip_by_per_variable_norm", capture)
    tcfg = bt.TrainConfig(batch_size=B)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.parameters(), d_model=CFG["decoder_dim"]))
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    state, aux = bt.make_pretrain_step(model)(state, batch)
    assert state.step == 1 and set(aux) == set(ref["metrics"])
    for k in ref["metrics"]:
        np.testing.assert_allclose(aux[k].item(), float(ref["metrics"][k]),
                                   rtol=tol["loss"], err_msg=k)
    grads = bt.to_flax_layout(model, raw)["params"]
    _assert_trees_close(grads, ref["grads"], tol["rel"], "grad", tol["floor"])
    layout = bt.to_flax_layout(model, model.state_dict())
    _assert_trees_close(layout["params"], ref["params"], tol["param"],
                        "new param")
    _assert_trees_close(layout["batch_stats"], ref["batch_stats"], 1e-5,
                        "new running stat")


def test_loss_and_gradients_match_jax_at_frozen_statistics(reference):
    tol = STEP_TOL["frozen"]
    ref = reference["frozen"]
    model = _port(ref["variables"]).eval()
    batch = reference["batch"]
    outs = model(torch.from_numpy(batch["image"]), return_intermediate=True)
    metrics = tpre.pretrain_loss(outs, torch.from_numpy(
        batch["category_ids"]), CLASSES)
    metrics["loss"].backward()
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"],
                               rtol=tol["loss"])
    assert metrics["accuracy"].item() == pytest.approx(ref["accuracy"])
    grads = bt.to_flax_layout(model, {n: p.grad for n, p in
                                      model.named_parameters()})["params"]
    _assert_trees_close(grads, ref["grads"], tol["rel"], "grad", tol["floor"])


def _detr_variables(image, seed):
    return tiny_variables(JaxDETR(jconfig.ModelConfig(**CFG)), image, seed)


def _port_detr(variables):
    model = bt.DETR(bt.ModelConfig(**CFG), device="cpu")
    bt.load_flax_variables(model, variables)
    return model


def test_transfer_to_detr_and_load_from_detr_match_jax(reference):
    """The trunk moves between a pre-trainer and a detector as JAX's tree
    surgery moves it: the detector's heads stay its own; the pre-trainer's
    classifier head stays its own."""
    pre_vars = reference["variables"]
    detr_vars = _detr_variables(reference["batch"]["image"], seed=8)
    # pre-trainer -> detector
    want = jpre.transfer_to_detr(pre_vars, detr_vars)
    detr = tpre.transfer_to_detr(_port(pre_vars), _port_detr(detr_vars))
    got = bt.to_flax_layout(detr, detr.state_dict())
    for coll in ("params", "batch_stats"):
        _assert_trees_close(got[coll], _to_np(want[coll]), 0.0, coll)
    # detector -> pre-trainer (JAX's tree also carries the head leaves the
    # pre-trainer never reads; the port's has no place for them)
    want = jpre.load_from_detr(pre_vars, detr_vars)
    pre = tpre.load_from_detr(_port(pre_vars), _port_detr(detr_vars))
    got = bt.to_flax_layout(pre, pre.state_dict())
    heads = ("category_head", "attribute_head", "box_head")
    for coll in ("params", "batch_stats"):
        tree = dict(want[coll])
        tree["detr"] = {k: v for k, v in tree["detr"].items()
                        if k not in heads}
        _assert_trees_close(got[coll], _to_np(tree), 0.0, coll)
    with pytest.raises(KeyError, match="trunks differ"):
        tpre.transfer_to_detr(_port(pre_vars), bt.DETR(bt.ModelConfig(
            **dict(CFG, num_decoder_blocks=1)), device="cpu"))


def test_bf16_smoke(reference):
    variables = reference["variables"]
    image = reference["batch"]["image"]
    jmodel = jpre.DETRMultiClassifier(
        jconfig.ModelConfig(**dict(CFG, compute_dtype="bfloat16")), CLASSES)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, image), np.float32)
    model = _port(variables, compute_dtype="bfloat16").eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(image))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-2, rtol=0)


def test_parameter_count_at_the_flagship_config():
    """The 640 flagship's config over its 82 categories: the JAX model's
    27,926,354 parameters (``jax.eval_shape``), the trunk without heads."""
    cfg = bt.ModelConfig(image_size=(640, 640), use_pallas_stem=True,
                         compute_dtype="bfloat16", max_objects=32,
                         num_categories=82, num_attributes=296,
                         backbone="resnet", stem="patchify8")
    model = bt.DETRMultiClassifier(cfg, cfg.num_categories, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 27_926_354
