"""The port's staged training of the boosted ensemble (one weak learner
trained, the rest frozen: ``TrainConfig.train_block`` with
``make_optimizer(trainable_mask=boosted_block_mask(model, k))``) against
the JAX package's step made with ``make_optimizer(trainable_mask=
boosted_block_mask(params, k))``, on the CPU, with
tests/test_torch_boosted_train.py's model, batch and optimizer, in the
``live`` regime (batch statistics, so that the frozen backbone's running
statistics move). Frozen leaves must stay bit for bit the same and get no
gradient at all: the staged step does no backward work for the backbone
(the stem's weight gradient, K1-dW on the card, is not called)."""

import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.ops import patchify as tpatchify
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.train import steps as jsteps
from test_torch_boosted_train import (B, PORT_CFG, assert_step_matches,
                                      boosted_batch, boosted_variables,
                                      jax_step, port_model, port_step,
                                      torch_batch)
from test_torch_train import STEP_TOL, _leaves

torch.set_num_threads(2)

BLOCK = 1
# the leaves weak learner 1 trains: its own scopes and the shared queries
TRAINED = {"encoder_1", "decoder_block_1", "category_head_1",
           "attribute_head_1", "box_head_1", "decoder_prep"}


@pytest.fixture(scope="module")
def reference():
    """The JAX staged step at ``train_block=1``, with intermediate losses
    (the forward stops at block 1, the loss is block 1's) and without (the
    full forward and the last block's loss; only the mask freezes)."""
    batch = boosted_batch(3)
    variables = boosted_variables(batch["image"], seed=4)
    mask = jsteps.boosted_block_mask(variables["params"], BLOCK)
    ref = {"batch": batch, "variables": variables,
           "mask": {k for k, v in _leaves(mask) if v}}
    for intermediate in (True, False):
        tcfg = jconfig.TrainConfig(batch_size=B, train_block=BLOCK,
                                   use_intermediate_losses=intermediate)
        ref[intermediate] = jax_step(variables, batch, tcfg,
                                     trainable_mask=mask)
    return ref


def _count_dw(monkeypatch):
    """Counts the calls of the stem's weight gradient (``patchify_conv_dw``:
    K1-dW on a CUDA tensor, its plain version here)."""
    calls = []
    dw = tpatchify.patchify_conv_dw

    def counted(*args, **kw):
        calls.append(1)
        return dw(*args, **kw)

    monkeypatch.setattr(tpatchify, "patchify_conv_dw", counted)
    return calls


def test_block_mask_matches_jax(reference):
    model = port_model(reference["variables"])
    mask = bt.boosted_block_mask(model, BLOCK)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    assert {n.split(".")[0] for n, on in mask.items() if on} == TRAINED
    trained = {n: p for n, p in model.named_parameters() if mask[n]}
    ours = {k for k, _ in _leaves(bt.to_flax_layout(model, trained)
                                  ["params"])}
    assert ours == reference["mask"]


@pytest.mark.parametrize("intermediate", [True, False])
def test_staged_step_matches_jax(reference, monkeypatch, intermediate):
    ref = reference[intermediate]
    model = port_model(reference["variables"])
    start = {k: v.clone() for k, v in model.state_dict().items()}
    mask = bt.boosted_block_mask(model, BLOCK)
    tcfg = bt.TrainConfig(batch_size=B, train_block=BLOCK,
                          use_intermediate_losses=intermediate)
    dw_calls = _count_dw(monkeypatch)
    state, aux, raw = port_step(model, reference["batch"], tcfg, monkeypatch,
                                trainable_mask=mask)
    # gradients for the trained leaves only; the frozen ones have none,
    # keep their flag, and stay bit for bit the same
    assert set(raw) == {n for n, on in mask.items() if on}
    assert not dw_calls
    moved = set()
    for name, p in model.named_parameters():
        assert p.requires_grad, name
        if mask[name]:
            moved.add(name)
            continue
        assert p.grad is None, name
        assert torch.equal(p.detach(), start[name]), name
    assert all(not torch.equal(model.state_dict()[n], start[n])
               for n in moved if not n.endswith("key_projection.bias"))
    # the frozen backbone's running statistics move in train mode, as
    # Flax's mutable batch_stats do; the new tree matches JAX's below
    stem_stats = "backbone.resnet.stem.norm.running_mean"
    assert not torch.equal(model.state_dict()[stem_stats], start[stem_stats])
    assert_step_matches(model, aux, raw, ref, STEP_TOL["live"])
    assert len(state.optimizer.params) == len(moved)


def test_unmasked_step_after_a_staged_one_trains_every_leaf(
        reference, monkeypatch):
    """No ``requires_grad`` flag or optimizer state leaks out of a staged
    step: a step and an optimizer built after it without a mask give every
    leaf a gradient and call the stem's weight gradient again."""
    model = port_model(reference["variables"])
    batch = torch_batch(reference["batch"])
    staged = bt.TrainConfig(batch_size=B, train_block=BLOCK,
                            use_intermediate_losses=True)
    state = bt.TrainState.create(model, bt.make_optimizer(
        staged, model.named_parameters(),
        trainable_mask=bt.boosted_block_mask(model, BLOCK)))
    state, _ = bt.make_train_step(model, PORT_CFG, staged)(state, batch)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    dw_calls = _count_dw(monkeypatch)
    joint = bt.TrainConfig(batch_size=B, use_intermediate_losses=True)
    state = bt.TrainState.create(model, bt.make_optimizer(
        joint, model.parameters()))
    state, _ = bt.make_train_step(model, PORT_CFG, joint)(state, batch)
    assert len(dw_calls) == 1
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        if not name.endswith("key_projection.bias"):
            assert not torch.equal(p.detach(), before[name]), name


def test_apply_trainable_mask_rebuilds_any_optimizer(reference):
    """``apply_trainable_mask`` on an optimizer over every leaf gives the
    optimizer that ``make_optimizer(trainable_mask=...)`` builds: the same
    step, bit for bit."""
    batch = torch_batch(reference["batch"])
    tcfg = bt.TrainConfig(batch_size=B, train_block=BLOCK,
                          use_intermediate_losses=True, optimizer="adamw",
                          weight_decay=0.01, lr_schedule="constant")
    results = []
    for wrap in (False, True):
        model = port_model(reference["variables"])
        mask = bt.boosted_block_mask(model, BLOCK)
        if wrap:
            opt = bt.apply_trainable_mask(
                bt.make_optimizer(tcfg, model.parameters()),
                model.named_parameters(), mask)
        else:
            opt = bt.make_optimizer(tcfg, model.named_parameters(),
                                    trainable_mask=mask)
        assert len(opt.params) == sum(mask.values())
        assert opt.inner.defaults["weight_decay"] == 0.01
        state = bt.TrainState.create(model, opt)
        bt.make_train_step(model, PORT_CFG, tcfg)(state, batch)
        results.append(model.state_dict())
    for k, v in results[0].items():
        assert torch.equal(results[1][k], v), k
    with pytest.raises(ValueError, match="named parameters"):
        bt.make_optimizer(tcfg, model.parameters(), trainable_mask=mask)
    with pytest.raises(KeyError, match="different leaves"):
        bt.make_optimizer(tcfg, model.named_parameters(),
                          trainable_mask={"neck.conv.weight": True})
