"""The port's joint train step of the boosted ensemble (every weak learner
trained at once, the blocks' losses folded into one matcher call by
``use_intermediate_losses``) and ``with_ema_params``,
against the JAX package's ``make_train_step`` and ``with_ema_params`` on
the CPU. The model is tests/test_torch_boosted.py's TINY with the Pallas
stem on (run through the interpreter on the JAX side, the plain versions
of K1 and K1-dW on the port's), batch 8 with 3 objects, SGD with Nesterov
momentum, clipnorm 0.1 and the cosine-restarts schedule, EMA decay 0.9.
The tolerances are tests/test_torch_train.py's ``STEP_TOL`` regimes:
``frozen`` (``freeze_bn_stats`` from calibrated running statistics: the
sides differ by sum order only) and ``live`` (batch statistics, which
amplify rounding). Dropout is 0: the sides cannot draw the same bits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tbackbone
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models.boosted import BoostedDETR as JaxBoosted
from boosted_detr_tpu.train import steps as jsteps
from test_torch_boosted import TINY, tiny_variables
from test_torch_train import (STEP_TOL, _assert_trees_close,
                              _capture_raw_grads, _leaves)

torch.set_num_threads(2)

CFG = dict(TINY, use_pallas_stem=True)
B, O = 8, 3
JAX_CFG = jconfig.ModelConfig(**CFG, matcher="hungarian")
PORT_CFG = bt.ModelConfig(**CFG, matcher="pallas")
EMA = 0.9


def boosted_batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
            "category_ids": rng.integers(2, 6, (B, O)).astype(np.int32),
            "attribute_ids": rng.integers(0, 4, (B, O, 2)).astype(np.int32),
            "bbox": rng.uniform(0.05, 0.45, (B, O, 4)).astype(np.float32),
            "num_objects": rng.integers(0, O + 1, (B,)).astype(np.int32)}


def boosted_variables(image, seed):
    """tests/test_torch_boosted.py's draws on the tree of the plain stem
    (the same tree as the Pallas stem's, traced without the kernel)."""
    return tiny_variables(JaxBoosted(dataclasses.replace(
        JAX_CFG, use_pallas_stem=False)), image, seed)


def port_model(variables):
    model = bt.BoostedDETR(PORT_CFG, device="cpu")
    bt.load_flax_variables(model, variables)
    return model


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_step(variables, batch, tcfg, trainable_mask=None, ema=False):
    """One JAX train step from ``variables``: its aux, the raw gradients,
    the new parameters and running statistics, and the EMA weights."""
    svars = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = optax.chain(_capture_raw_grads(), jsteps.make_optimizer(
        tcfg, d_model=CFG["decoder_dim"], trainable_mask=trainable_mask))
    state = jsteps.TrainState.create(svars["params"], svars["batch_stats"],
                                     tx, ema=ema)
    step = jax.jit(jsteps.make_train_step(JaxBoosted(JAX_CFG), JAX_CFG,
                                          tcfg))
    new, aux = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(2))
    out = {"variables": variables, "aux": _to_np(aux),
           "grads": _to_np(new.opt_state[0]), "params": _to_np(new.params),
           "batch_stats": _to_np(new.batch_stats)}
    if ema:
        out["ema"] = _to_np(jsteps.with_ema_params(new).params)
    return out


def calibrated(variables, image):
    """Running statistics that normalise ``image`` without amplifying (its
    batch means, its batch variances plus 1), as
    tests/test_torch_train.py::_calibrated makes them."""
    model = port_model(variables).train()
    for m in model.modules():
        if isinstance(m, tbackbone.BatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        model(torch.from_numpy(image))
    stats = {k: v + 1.0 if k.endswith("running_var") else v
             for k, v in model.state_dict().items() if "running" in k}
    return dict(variables,
                batch_stats=bt.to_flax_layout(model, stats)["batch_stats"])


def port_step(model, batch, tcfg, monkeypatch, trainable_mask=None,
              ema=False):
    """One port train step; returns (state, aux, the raw gradients by name
    as the backward left them, before the clip)."""
    raw = {}
    clip = tsteps.clip_by_per_variable_norm

    def capture(grads, max_norm):
        raw.update({name: p.grad.clone()
                    for name, p in model.named_parameters()
                    if p.grad is not None})
        clip(grads, max_norm)

    monkeypatch.setattr(tsteps, "clip_by_per_variable_norm", capture)
    params = (model.named_parameters() if trainable_mask is not None
              else model.parameters())
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, params, d_model=CFG["decoder_dim"],
        trainable_mask=trainable_mask), ema=ema)
    state, aux = bt.make_train_step(model, PORT_CFG, tcfg)(
        state, torch_batch(batch))
    monkeypatch.setattr(tsteps, "clip_by_per_variable_norm", clip)
    return state, aux, raw


def assert_step_matches(model, aux, raw, ref, tol):
    """Loss and aux, the raw gradients the port computed (by Flax path),
    new parameters and running statistics against a JAX step's."""
    assert set(aux) == set(ref["aux"])
    for k in ref["aux"]:
        np.testing.assert_allclose(aux[k].item(), float(ref["aux"][k]),
                                   rtol=tol["loss"], atol=1e-6, err_msg=k)
    grads = dict(_leaves(bt.to_flax_layout(model, raw)["params"]))
    want = {k: v for k, v in _leaves(ref["grads"]) if k in grads}
    _assert_trees_close(grads, want, tol["rel"], "grad", tol["floor"])
    whole = np.sqrt(sum(np.sum(np.square(grads[k] - want[k])) for k in want)
                    / sum(np.sum(np.square(w)) for w in want.values()))
    assert whole <= tol["whole"], whole
    layout = bt.to_flax_layout(model, model.state_dict())
    _assert_trees_close(layout["params"], ref["params"], tol["param"],
                        "new param")
    _assert_trees_close(layout["batch_stats"], ref["batch_stats"], 1e-5,
                        "new running stat")


@pytest.fixture(scope="module")
def reference():
    """The JAX joint step (intermediate losses, EMA) in both regimes."""
    batch = boosted_batch(0)
    variables = boosted_variables(batch["image"], seed=1)
    ref = {"batch": batch, "variables": variables}
    for regime in ("frozen", "live"):
        start = (calibrated(variables, batch["image"]) if regime == "frozen"
                 else variables)
        tcfg = jconfig.TrainConfig(batch_size=B, use_intermediate_losses=True,
                                   freeze_bn_stats=regime == "frozen",
                                   ema_decay=EMA)
        ref[regime] = jax_step(start, batch, tcfg, ema=True)
    return ref


@pytest.mark.parametrize("regime", ["frozen", "live"])
def test_joint_step_matches_jax(reference, monkeypatch, regime):
    ref = reference[regime]
    model = port_model(ref["variables"])
    tcfg = bt.TrainConfig(batch_size=B, use_intermediate_losses=True,
                          freeze_bn_stats=regime == "frozen", ema_decay=EMA)
    state, aux, raw = port_step(model, reference["batch"], tcfg, monkeypatch,
                                ema=True)
    assert state.step == 1
    assert len(raw) == len(list(model.parameters()))
    assert_step_matches(model, aux, raw, ref, STEP_TOL[regime])


def test_ema_params_match_jax(reference, monkeypatch):
    ref = reference["frozen"]
    model = port_model(ref["variables"])
    tcfg = bt.TrainConfig(batch_size=B, use_intermediate_losses=True,
                          freeze_bn_stats=True, ema_decay=EMA)
    state, _, _ = port_step(model, reference["batch"], tcfg, monkeypatch,
                            ema=True)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    swapped = bt.with_ema_params(state)
    # the training state is untouched, and refuses the copy's model
    assert swapped.model is not model and state.model is model
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    layout = bt.to_flax_layout(swapped.model, swapped.model.state_dict())
    _assert_trees_close(layout["params"], ref["ema"],
                        STEP_TOL["frozen"]["param"], "EMA param")
    _assert_trees_close(layout["batch_stats"], ref["batch_stats"], 1e-5,
                        "running stat")
    with pytest.raises(ValueError, match="another model"):
        bt.make_train_step(model, PORT_CFG, tcfg)(
            swapped, torch_batch(reference["batch"]))
    # no shadow: both packages raise
    plain = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.parameters()))
    with pytest.raises(ValueError, match="no EMA shadow"):
        bt.with_ema_params(plain)
    jvars = jax.tree_util.tree_map(jnp.asarray, ref["variables"])
    jstate = jsteps.TrainState.create(jvars["params"], jvars["batch_stats"],
                                      optax.sgd(0.1))
    with pytest.raises(ValueError, match="no EMA shadow"):
        jsteps.with_ema_params(jstate)
