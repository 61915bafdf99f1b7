"""The port's training path (boosted_detr_torch: BatchNorm in training mode,
dropout, the train-mode DETR forward, schedules, optimizers and
``make_train_step``) against the JAX package's, on the CPU, at a small
size: 64x64 images, ResNet patchify8 at width 0.25 with the Pallas stem
(run through the interpreter on the JAX side), 2+2 blocks of width 64, 16
queries, 12 categories, 20 attributes, 8 objects, float32 compute. Weights
are Flax's init perturbed by seeded noise with random running statistics,
carried across by ``load_flax_variables``; batches are made with numpy.
Dropout bits cannot match between the two packages, so the parity tests
run at ``dropout_rate=0``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tbackbone
from boosted_detr_torch.models import layers as tlayers
from boosted_detr_torch.train import schedules as tsched
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.train import schedules as jsched
from boosted_detr_tpu.train import steps as jsteps

torch.set_num_threads(2)

SMALL = dict(image_size=(64, 64), backbone="resnet", backbone_width=0.25,
             stem="patchify8", use_pallas_stem=True, norm="batchnorm",
             num_encoder_blocks=2, num_decoder_blocks=2, encoder_dim=64,
             decoder_dim=64, num_object_preds=16, num_categories=12,
             num_attributes=20, max_objects=8, compute_dtype="float32",
             dropout_rate=0.0)
B = 8
# The JAX side's matcher is its XLA solver: its Pallas dispatch does not
# run on the CPU outside interpret mode. The port's "pallas" takes its plain
# solver on CPU tensors; on these tie-free costs both give one assignment.
JAX_CFG = jconfig.ModelConfig(**SMALL, matcher="hungarian")
PORT_CFG = bt.ModelConfig(**SMALL, matcher="pallas")
# float32 throughout, the same formulas, two regimes (measured here):
# - with running statistics that do not amplify (``freeze_bn_stats``, the
#   train=False forward, from ``_calibrated`` statistics) the sides differ
#   by sum order only: losses agree to 3.3e-7 relative, the whole gradient
#   to 6.3e-7 of its norm, every leaf to 4.1e-5 of its own;
# - with live batch statistics this small model amplifies rounding: at B=8,
#   with a 2x2 last stage, a relative perturbation of 1e-7 at the input
#   moves the category probabilities by ~2e-4 and the port's own gradient
#   by 1.55e-2 of its norm (its stem kernel's leaf by 9.7e-3), and XLA and
#   torch round differently at every layer. Against JAX: losses 1.2e-5,
#   the whole gradient 1.4e-2, the worst leaf (the stem) 8.6e-3: the
#   difference is the size of float32 noise through this model, so the
#   tolerance is set a few times above it.
# Per leaf the error is held to ``rel`` of the leaf's norm plus ``floor``
# of the whole tree's; the floor covers gradients that are zero by
# symmetry (a key-projection bias shifts all of one query's logits alike,
# which softmax ignores), where both sides hold rounding noise only.
STEP_TOL = {"frozen": dict(loss=1e-5, rel=1e-4, floor=1e-6, whole=1e-4,
                       param=1e-6),
            "live": dict(loss=1e-4, rel=0.0, floor=3e-2, whole=5e-2,
                         param=3e-5)}


def _batch(rng):
    return {"image": rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
            "category_ids": rng.integers(2, 12, (B, 8)).astype(np.int32),
            "attribute_ids": rng.integers(0, 20, (B, 8, 4)).astype(np.int32),
            "bbox": rng.uniform(0.05, 0.45, (B, 8, 4)).astype(np.float32),
            "num_objects": rng.integers(0, 9, (B,)).astype(np.int32)}


def _variables(image, seed):
    """Flax init (through the plain stem: the same tree, no interpreter),
    every parameter shifted by seeded noise, random running statistics."""
    rng = np.random.default_rng(seed)
    init = jax.jit(JaxDETR(dataclasses.replace(
        JAX_CFG, use_pallas_stem=False)).init)
    variables = init(jax.random.PRNGKey(0), image)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        scale = 0.3 if leaf == "mean" else 0.1
        return a + (rng.standard_normal(a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _port_model(variables):
    model = bt.DETR(PORT_CFG, device="cpu")
    bt.load_flax_variables(model, variables)
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _capture_raw_grads():
    """An optax stage that keeps the raw gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _calibrated(variables, image):
    """``variables`` with running statistics that normalise ``image``
    without amplifying: its own batch means (one train-mode forward of the
    port at momentum 0) and its batch variances plus 1, so that no channel
    is divided by less than 1. Random statistics do not normalise: through
    13 blocks the activations grow to ~1e3 and the neck's tanh saturates,
    which would leave the backbone without gradient."""
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


@pytest.fixture(scope="module")
def reference():
    """One JAX train-mode forward and one JAX ``make_train_step`` step from
    the same weights and batch (SGD, Nesterov, clipnorm 0.1, the
    cosine-restarts schedule: the flagship's TrainConfig)."""
    batch = _batch(np.random.default_rng(0))
    variables = _variables(batch["image"], seed=1)
    jmodel = JaxDETR(JAX_CFG)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    outs, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, return_intermediate=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(1)}))(jvars, batch["image"])
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    ref = {"batch": batch, "variables": variables, "outs": to_np(outs),
           "forward_stats": to_np(mutated["batch_stats"])}
    for frozen in (False, True):
        start = _calibrated(variables, batch["image"]) if frozen else variables
        svars = jax.tree_util.tree_map(jnp.asarray, start)
        tcfg = jconfig.TrainConfig(batch_size=B, freeze_bn_stats=frozen)
        tx = optax.chain(_capture_raw_grads(),
                         jsteps.make_optimizer(tcfg, d_model=64))
        state = jsteps.TrainState.create(svars["params"],
                                         svars["batch_stats"], tx)
        step = jax.jit(jsteps.make_train_step(jmodel, JAX_CFG, tcfg))
        new_state, aux = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jax.random.PRNGKey(2))
        ref["frozen" if frozen else "live"] = {
            "variables": start, "aux": to_np(aux), "grads": to_np(new_state.opt_state[0]),
            "params": to_np(new_state.params),
            "batch_stats": to_np(new_state.batch_stats)}
    return ref


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_trees_close(ours, ref, rel, what, floor=0.0):
    """Per leaf: ||ours - ref|| <= rel ||ref leaf|| + floor ||ref tree||."""
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    total = np.sqrt(sum(np.sum(np.square(r)) for r in ref.values()))
    for name, r in ref.items():
        o = ours[name]
        assert o.shape == r.shape, (what, name)
        err = np.linalg.norm(o - r)
        bound = rel * np.linalg.norm(r) + floor * total
        assert err <= bound, (f"{what} {name}: error {err:.3e} over "
                              f"{bound:.3e}")


def test_train_config_copies_have_the_same_fields_and_defaults():
    for ours, ref in ((bt.TrainConfig, jconfig.TrainConfig),
                      (bt.LossWeights, jconfig.LossWeights)):
        got = [(f.name, f.default) for f in dataclasses.fields(ours)]
        want = [(f.name, f.default) for f in dataclasses.fields(ref)]
        assert got == want
    assert bt.TrainConfig().loss_weights == bt.LossWeights()


@pytest.mark.parametrize("shape,dtype", [((4, 3, 5, 6), torch.float32),
                                         ((4, 3, 5, 6), torch.bfloat16),
                                         ((3, 7, 6), torch.float32)])
def test_batchnorm_training_mode_matches_flax(shape, dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                        epsilon=1e-3, dtype=jdt)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
            np.float32), variables)
    ref, mutated = jbn.apply(variables, jnp.asarray(x, jdt),
                             mutable=["batch_stats"])
    bn = tbackbone.BatchNorm(6, dtype).train()
    bt.load_flax_variables(bn, variables)
    out = bn(torch.from_numpy(x).to(dtype))
    assert out.dtype == dtype
    # float32: only the order of the float32 means differs. bfloat16: the
    # same float32 normalisation, then one rounding to bf16 (2**-8).
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=8e-3))
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(ref, np.float32), **tol)
    stats = bt.to_flax_layout(bn, {k: v for k, v in bn.state_dict().items()
                                   if k.startswith("running")})
    for leaf in ("mean", "var"):  # the biased fast variance, momentum 0.99
        np.testing.assert_allclose(stats["batch_stats"][leaf],
                                   np.asarray(mutated["batch_stats"][leaf]),
                                   rtol=1e-6, atol=1e-7)


def test_dropout_keeps_scales_and_is_seeded():
    x = torch.ones(20000, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    out = tlayers.dropout(x, 0.1, gen)
    kept = out != 0
    # keep rate 0.9: 4.5 standard deviations of a binomial is 0.0095
    assert abs(kept.float().mean().item() - 0.9) < 0.0095
    # kept values are divided by 0.9 in bf16
    assert torch.equal(out[kept], (x[kept] / 0.9))
    again = tlayers.dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    other = tlayers.dropout(x, 0.1, torch.Generator().manual_seed(4))
    assert not torch.equal(out, other)
    assert tlayers.dropout(x, 0.1, None) is x
    assert tlayers.dropout(x, 0.0, gen) is x


def test_training_forward_needs_a_generator_for_dropout():
    model = bt.DETR(dataclasses.replace(PORT_CFG, dropout_rate=0.1),
                    device="cpu").train()
    image = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match="generator"):
        model(image)
    a = model(image, generator=torch.Generator().manual_seed(0))
    b = model(image, generator=torch.Generator().manual_seed(0))
    c = model(image, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a["boxes"], b["boxes"], atol=0, rtol=0)
    assert not torch.equal(a["category"], c["category"])


def test_training_forward_matches_jax(reference):
    """Both decoder blocks' predictions; each head runs once a block, so its
    running statistics update twice, as Flax's mutable collection does."""
    model = _port_model(reference["variables"]).train()
    outs = model(torch.from_numpy(reference["batch"]["image"]),
                 return_intermediate=True)
    assert len(outs) == len(reference["outs"]) == 2
    # live batch statistics: probabilities measured within 4e-4 of JAX's
    # (the amplification above), boxes within 1e-5
    for out, ref in zip(outs, reference["outs"]):
        for key, atol in (("category", 2e-3), ("attribute", 2e-3),
                          ("boxes", 1e-4)):
            np.testing.assert_allclose(out[key].detach().numpy(), ref[key],
                                       atol=atol, rtol=0, err_msg=key)
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    _assert_trees_close(bt.to_flax_layout(model, stats)["batch_stats"],
                        reference["forward_stats"], 1e-4, "running stat")


@pytest.mark.parametrize("regime", ["frozen", "live"])
def test_one_train_step_matches_jax(reference, monkeypatch, regime):
    """One flagship-recipe step (SGD, Nesterov 0.9, clipnorm 0.1 per
    tensor, cosine restarts) from bridged weights: loss and every aux loss,
    the gradients leaf by leaf, the new parameters and running
    statistics."""
    tol = STEP_TOL[regime]
    ref = reference[regime]
    model = _port_model(ref["variables"])
    raw = {}
    clip = tsteps.clip_by_per_variable_norm

    def capture(grads, max_norm):  # the raw gradients, before the clip
        raw.update({name: p.grad.clone()
                    for name, p in model.named_parameters()})
        clip(grads, max_norm)

    monkeypatch.setattr(tsteps, "clip_by_per_variable_norm", capture)
    tcfg = bt.TrainConfig(batch_size=B, freeze_bn_stats=regime == "frozen")
    state = bt.TrainState.create(
        model, bt.make_optimizer(tcfg, model.parameters(), d_model=64))
    step = bt.make_train_step(model, PORT_CFG, tcfg)
    state, aux = step(state, _torch_batch(reference["batch"]))
    assert state.step == 1 and state.optimizer.count == 1

    assert set(aux) == set(ref["aux"])
    for k in ref["aux"]:
        np.testing.assert_allclose(aux[k].item(), float(ref["aux"][k]),
                                   rtol=tol["loss"], atol=1e-6, err_msg=k)
    grads = bt.to_flax_layout(model, raw)["params"]
    _assert_trees_close(grads, ref["grads"], tol["rel"], "grad", tol["floor"])
    ours, want = dict(_leaves(grads)), dict(_leaves(ref["grads"]))
    whole = np.sqrt(sum(np.sum(np.square(ours[k] - want[k])) for k in want)
                    / sum(np.sum(np.square(w)) for w in want.values()))
    assert whole <= tol["whole"], whole
    # the first Nesterov step moves a parameter by lr 1.9 clip(g), up to
    # ~2e-4 a leaf: its error is the clipped gradient's times 1.9e-3
    layout = bt.to_flax_layout(model, model.state_dict())
    _assert_trees_close(layout["params"], ref["params"], tol["param"],
                        "new param")
    # running statistics: measured within 1.1e-6 (live), unchanged (frozen)
    _assert_trees_close(layout["batch_stats"], ref["batch_stats"], 1e-5,
                        "new running stat")
    stem = model.backbone.resnet.stem.conv.weight.grad
    assert stem is not None and stem.abs().sum() > 0


def _optimizer_pair(tcfg, shapes, seed):
    rng = np.random.default_rng(seed)
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate(shapes)}
    torch_params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for v in params.values()]
    ours = bt.make_optimizer(tcfg, torch_params, d_model=64)
    tx = jsteps.make_optimizer(jconfig.TrainConfig(**dataclasses.asdict(
        tcfg) | {"loss_weights": jconfig.LossWeights()}), d_model=64)
    return params, torch_params, ours, tx


OPT_TOL = {"sgd": dict(rtol=1e-6, atol=1e-7),
           "adamw": dict(rtol=1e-5, atol=5e-6)}


@pytest.mark.parametrize("optimizer,schedule", [
    ("sgd", "aiayn"), ("sgd", "cosine_restarts"), ("adamw", "constant")])
def test_optimizer_steps_match_optax(optimizer, schedule):
    # per-tensor clipnorm 0.1 with one gradient far above it and one below,
    # over four steps so that momentum, Adam's moments and the schedule's
    # count all move
    tcfg = bt.TrainConfig(optimizer=optimizer, lr_schedule=schedule,
                          warmup_steps=3, learning_rate=0.05,
                          weight_decay=0.01 if optimizer == "adamw" else 0.0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params, torch_params, ours, tx = _optimizer_pair(tcfg, shapes, 5)
    opt_state = tx.init(params)
    rng = np.random.default_rng(6)
    for _ in range(4):
        grads = {k: (rng.standard_normal(v.shape) * s).astype(np.float32)
                 for (k, v), s in zip(params.items(), (10.0, 0.001, 1.0))}
        for p, g in zip(torch_params, grads.values()):
            p.grad = torch.from_numpy(g.copy())
        ours.step()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # SGD: the same float32 arithmetic in another order. AdamW: each
        # step moves a parameter by ~lr = 0.05, and optax takes the bias
        # corrections 1 - 0.999^t in float32 (0.999 is inexact there: 1.3e-5
        # relative at t = 1) where torch takes them in double
        for p, ref in zip(torch_params, params.values()):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       **OPT_TOL[optimizer])
    assert ours.count == 4


@pytest.mark.parametrize("name", ["cosine_restarts", "aiayn", "constant"])
def test_schedules_match_jax(name):
    ours = tsched.make_schedule(name, 1e-3, 4000, 256)
    ref = jsched.make_schedule(name, 1e-3, 4000, 256)
    for step in (0, 1, 7, 3999, 4000, 4001, 11999, 12000, 50000):
        np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))),
                                   rtol=2e-6, err_msg=str(step))
    cyc = tsched.aiayn_schedule(64, 10, scale=2.0, cycle_steps=25)
    jcyc = jsched.aiayn_schedule(64, 10, scale=2.0, cycle_steps=25)
    for step in (0, 5, 24, 25, 26, 60):
        np.testing.assert_allclose(cyc(step), float(jcyc(jnp.int32(step))),
                                   rtol=2e-6)


def _fresh_state(variables, **train_kw):
    model = _port_model(variables)
    tcfg = bt.TrainConfig(batch_size=B, **train_kw)
    opt = bt.make_optimizer(tcfg, model.parameters(), d_model=64)
    state = bt.TrainState.create(model, opt, ema=tcfg.ema_decay > 0)
    return state, bt.make_train_step(model, PORT_CFG, tcfg), tcfg


def test_intermediate_losses_fold_the_blocks_and_average(reference):
    state, step, tcfg = _fresh_state(reference["variables"],
                                     use_intermediate_losses=True,
                                     intermediate_loss_avg=True)
    batch = _torch_batch(reference["batch"])
    twin = _port_model(reference["variables"]).train()
    with torch.no_grad():
        outs = twin(batch["image"], return_intermediate=True)
        want, want_aux = tsteps.compute_losses(outs, batch, PORT_CFG,
                                               tcfg.loss_weights)
    state, aux = step(state, batch)
    # the same forward on the same weights, then the mean over 2 blocks
    assert aux["loss"].item() == pytest.approx(want.item() / 2, rel=1e-6)
    assert aux["loss_box"].item() == pytest.approx(
        want_aux["loss_box"].item() / 2, rel=1e-6)
    assert aux["iou"].item() == pytest.approx(want_aux["iou"].item(),
                                              rel=1e-6)


def test_frozen_bn_stats_keep_the_running_statistics(reference):
    state, step, tcfg = _fresh_state(reference["variables"],
                                     freeze_bn_stats=True)
    batch = _torch_batch(reference["batch"])
    want = tsteps.make_eval_step(state.model, PORT_CFG, tcfg)(state, batch)
    stats = {k: v.clone() for k, v in state.model.state_dict().items()
             if "running" in k}
    state, aux = step(state, batch)
    # the train=False forward: the eval step's loss, statistics untouched
    assert aux["loss"].item() == want["loss"].item()
    for k, v in stats.items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_ema_shadow_follows_the_parameters(reference):
    state, step, _ = _fresh_state(reference["variables"], ema_decay=0.9)
    before = {k: v.clone() for k, v in state.ema_params.items()}
    state, _ = step(state, _torch_batch(reference["batch"]))
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema_params[name],
                                   before[name] * 0.9 + p.detach() * 0.1,
                                   atol=1e-7, rtol=1e-6)


def test_predict_between_train_steps_changes_nothing(reference):
    batch = _torch_batch(reference["batch"])
    cfg = dict(SMALL, dropout_rate=0.1)
    results = []
    for with_predict in (False, True):
        model = bt.DETR(bt.ModelConfig(**cfg, matcher="pallas"),
                        device="cpu")
        bt.load_flax_variables(model, reference["variables"])
        tcfg = bt.TrainConfig(batch_size=B)
        state = bt.TrainState.create(
            model, bt.make_optimizer(tcfg, model.parameters(), d_model=64))
        step = bt.make_train_step(model, model.config, tcfg)
        state, _ = step(state, batch)
        if with_predict:
            model.train()
            bt.predict(model, reference["batch"]["image"])
            assert model.training  # the mode it found is back
        state, aux = step(state, batch)
        results.append((aux["loss"].item(),
                        {k: v.clone() for k, v in model.state_dict().items()}))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        assert torch.equal(results[1][1][k], v), k


def test_options_not_ported_raise():
    model = bt.DETR(PORT_CFG, device="cpu")
    # a mesh of two ranks in a process with no process group (one rank)
    with pytest.raises(ValueError, match="mesh shape"):
        bt.make_train_step(model, PORT_CFG,
                           bt.TrainConfig(mesh_shape={"data": 2}))
    other = bt.DETR(PORT_CFG, device="cpu")
    state = bt.TrainState.create(
        other, bt.make_optimizer(bt.TrainConfig(), other.parameters()))
    with pytest.raises(ValueError, match="another model"):
        bt.make_train_step(model, PORT_CFG, bt.TrainConfig())(state, {})


def test_flax_layout_round_trips_through_the_bridge(reference):
    model = _port_model(reference["variables"])
    layout = bt.to_flax_layout(model, model.state_dict())
    _assert_trees_close(layout["params"], reference["variables"]["params"],
                        0.0, "param")
    _assert_trees_close(layout["batch_stats"],
                        reference["variables"]["batch_stats"], 0.0, "stat")
    with pytest.raises(KeyError):
        bt.to_flax_layout(model, {"no.such.weight": torch.zeros(1)})
