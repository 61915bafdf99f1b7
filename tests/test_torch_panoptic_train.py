"""The port's panoptic train and eval steps
(boosted_detr_torch/models/panoptic.py: ``make_panoptic_train_step``,
``make_panoptic_eval_step``, ``panoptic_losses``) against the JAX
package's on the CPU, on tests/test_torch_panoptic.py's model (TINY with 2
decoder blocks, mask size 16) and a batch of 8 images with up to 3 objects
and their box masks. Two regimes, with tests/test_torch_train.py's
``STEP_TOL``: the train step itself (live BatchNorm, which amplifies
float32 rounding: the ``live`` tolerances), and the panoptic loss and its
gradients at ``train=False`` from calibrated running statistics (the sides
differ by sum order only: the ``frozen`` tolerances; JAX's panoptic step
has no ``freeze_bn_stats``, so this regime is held through the loss
function both steps share). Also the eval step with two matchers (the
``matcher`` field moves the loss as JAX's moves) and a bf16 smoke test.
Dropout is 0: the sides cannot draw the same bits."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tbackbone
from boosted_detr_torch.models import panoptic as tp
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models import panoptic as jp
from boosted_detr_tpu.train import steps as jsteps
from test_torch_boosted import tiny_variables
from test_torch_boosted_train import _to_np
from test_torch_panoptic import CFG, MASK
from test_torch_train import STEP_TOL, _assert_trees_close, _capture_raw_grads

torch.set_num_threads(2)

B, O = 8, 3


def _batch(seed):
    rng = np.random.default_rng(seed)
    bbox = rng.uniform(0.05, 0.45, (B, O, 4)).astype(np.float32)
    n = rng.integers(0, O + 1, (B,)).astype(np.int32)
    return {"image": rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
            "category_ids": rng.integers(2, 6, (B, O)).astype(np.int32),
            "attribute_ids": rng.integers(0, 4, (B, O, 2)).astype(np.int32),
            "bbox": bbox, "num_objects": n,
            "masks": np.asarray(jp.masks_from_boxes(bbox, n, MASK))}


def _jax_model(**kw):
    return jp.DETRPanoptic(jconfig.ModelConfig(**dict(CFG, **kw)),
                           mask_size=MASK)


def _port_model(variables, **kw):
    model = bt.DETRPanoptic(bt.ModelConfig(**dict(CFG, **kw)),
                            mask_size=MASK, device="cpu")
    bt.load_flax_variables(model, variables)
    return model


def _calibrated(variables, image):
    """Running statistics that normalise ``image`` without amplifying (its
    batch means, its batch variances plus 1), as
    tests/test_torch_train.py::_calibrated makes them."""
    model = _port_model(variables).train()
    for m in model.modules():
        if isinstance(m, tbackbone.BatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        model(torch.from_numpy(image))
    stats = {k: v + 1.0 if k.endswith("running_var") else v
             for k, v in model.state_dict().items() if "running" in k}
    return dict(variables,
                batch_stats=bt.to_flax_layout(model, stats)["batch_stats"])


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    batch = _batch(0)
    jmodel = _jax_model()
    variables = tiny_variables(jmodel, batch["image"], seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tcfg = jconfig.TrainConfig(batch_size=B)
    ref = {"batch": batch, "variables": variables}
    # the live step: JAX's panoptic train step
    svars = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = optax.chain(_capture_raw_grads(), jsteps.make_optimizer(
        tcfg, d_model=CFG["decoder_dim"]))
    state = jsteps.TrainState.create(svars["params"], svars["batch_stats"],
                                     tx)
    new, aux = jax.jit(jp.make_panoptic_train_step(jmodel, tcfg))(
        state, jbatch, jax.random.PRNGKey(2))
    ref["live"] = {"aux": _to_np(aux), "grads": _to_np(new.opt_state[0]),
                   "params": _to_np(new.params),
                   "batch_stats": _to_np(new.batch_stats)}
    # the frozen regime: the shared loss at train=False and its gradients
    frozen = _calibrated(variables, batch["image"])

    def loss(params):
        preds = jmodel.apply({"params": params,
                              "batch_stats": frozen["batch_stats"]},
                             jbatch["image"])
        return jp._panoptic_losses(jmodel, tcfg, preds, jbatch, 1.0, 1.0)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, frozen["params"]))
    ref["frozen"] = {"variables": frozen, "loss": float(total),
                     "aux": _to_np(aux), "grads": _to_np(grads)}
    return ref


def test_train_step_matches_jax(reference, monkeypatch):
    """One panoptic step with live BatchNorm (SGD, Nesterov, clipnorm 0.1,
    cosine restarts): the losses, the raw gradients, the new parameters
    and running statistics, at the ``live`` tolerances."""
    tol = STEP_TOL["live"]
    ref = reference["live"]
    model = _port_model(reference["variables"])
    tcfg = bt.TrainConfig(batch_size=B)
    raw = {}
    clip = tsteps.clip_by_per_variable_norm

    def capture(grads, max_norm):
        raw.update({name: p.grad.clone()
                    for name, p in model.named_parameters()})
        clip(grads, max_norm)

    monkeypatch.setattr(tsteps, "clip_by_per_variable_norm", capture)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.parameters(), d_model=CFG["decoder_dim"]))
    state, aux = bt.make_panoptic_train_step(model, tcfg)(
        state, _torch(reference["batch"]))
    assert state.step == 1
    assert set(aux) == set(ref["aux"])
    for k in ref["aux"]:
        np.testing.assert_allclose(aux[k].item(), float(ref["aux"][k]),
                                   rtol=tol["loss"], atol=1e-6, err_msg=k)
    assert aux["loss_mask"].item() > 0
    grads = bt.to_flax_layout(model, raw)["params"]
    _assert_trees_close(grads, ref["grads"], tol["rel"], "grad", tol["floor"])
    layout = bt.to_flax_layout(model, model.state_dict())
    _assert_trees_close(layout["params"], ref["params"], tol["param"],
                        "new param")
    _assert_trees_close(layout["batch_stats"], ref["batch_stats"], 1e-5,
                        "new running stat")
    neck = model.panoptic_neck.up0.deconv.weight.grad
    assert neck is not None and neck.abs().sum() > 0


def test_loss_and_gradients_match_jax_at_frozen_statistics(reference):
    """The loss both steps share, at ``train=False`` from calibrated
    running statistics: within 1e-5, the gradients leaf by leaf within
    the ``frozen`` tolerances."""
    tol = STEP_TOL["frozen"]
    ref = reference["frozen"]
    model = _port_model(ref["variables"]).eval()
    batch = _torch(reference["batch"])
    preds = model(batch["image"])
    total, aux = tp.panoptic_losses(model, bt.TrainConfig(), preds, batch,
                                    1.0, 1.0)
    total.backward()
    np.testing.assert_allclose(total.item(), ref["loss"], rtol=tol["loss"])
    for k in ref["aux"]:
        np.testing.assert_allclose(aux[k].item(), float(ref["aux"][k]),
                                   rtol=tol["loss"], atol=1e-6, err_msg=k)
    grads = bt.to_flax_layout(model, {n: p.grad for n, p in
                                      model.named_parameters()})["params"]
    _assert_trees_close(grads, ref["grads"], tol["rel"], "grad", tol["floor"])
@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
def test_eval_step_matches_jax_with_each_matcher(reference, matcher):
    """The eval step (the panoptic loss at ``train=False``, detection and
    mask losses on one assignment) within 1e-5 of JAX's; the ``matcher``
    field moves it on both sides alike (greedy's assignment costs more)."""
    batch = reference["batch"]
    variables = reference["variables"]
    jmodel = _jax_model(matcher=matcher)
    step = jp.make_panoptic_eval_step(jmodel, jconfig.TrainConfig())
    ref = jax.jit(lambda params, stats, b: step(SimpleNamespace(
        params=params, batch_stats=stats), b))(
            variables["params"], variables["batch_stats"],
            {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(variables, matcher=matcher)
    aux = bt.make_panoptic_eval_step(model, bt.TrainConfig())(
        bt.TrainState(0, model, None), _torch(batch))
    assert set(aux) == set(ref)
    for k in ref:
        np.testing.assert_allclose(aux[k].item(), float(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    reference.setdefault("eval", {})[matcher] = aux["loss"].item()
    if len(reference["eval"]) == 2:
        assert reference["eval"]["greedy"] > reference["eval"]["hungarian"]


def test_bf16_smoke(reference):
    """bf16 compute: the same weights, JAX's and the port's outputs within
    a few bf16 roundings through the trunk and the U-Net."""
    variables = reference["variables"]
    image = reference["batch"]["image"]
    jmodel = _jax_model(compute_dtype="bfloat16")
    ref = {k: np.asarray(v, np.float32)
           for k, v in jax.jit(jmodel.apply)(variables, image).items()}
    model = _port_model(variables, compute_dtype="bfloat16").eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(image))
    assert out["masks"].dtype == torch.float32
    for key, atol in (("category", 5e-2), ("attribute", 5e-2),
                      ("boxes", 5e-2), ("masks", 0.25)):
        np.testing.assert_allclose(out[key].float().numpy(), ref[key],
                                   atol=atol, rtol=0, err_msg=key)
