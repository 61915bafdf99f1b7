"""The port's adaptive gradient clip (boosted_detr_torch/train/steps.py:
``unitwise_dims``, ``adaptive_grad_clip``, ``TrainConfig.agc_clip`` in
``make_optimizer``) against optax's ``adaptive_grad_clip`` and the JAX
package's masked chain (boosted_detr_tpu/train/steps.py:88-99), and one
train step of a small norm-free (``skipinit``) DETR with ``agc_clip=0.05``
against JAX's, on the CPU, float32; with the bridge round trip of the
norm-free and GroupNorm models' leaves."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.train import steps as jsteps
from test_torch_norms import _jax, draw
from test_torch_train import STEP_TOL, _assert_trees_close, _leaves

torch.set_num_threads(2)

# A DETR with no BatchNorm anywhere: the ResNet patchify8 stem through the
# fused route (JAX's Pallas stem in interpret mode), weight-standardised
# convs, skip_gain, GroupNorm in the neck, identity norms in the heads.
SKIPINIT = dict(image_size=(64, 64), backbone="resnet", backbone_width=0.01,
                stem="patchify8", use_pallas_stem=True, norm="skipinit",
                num_encoder_blocks=1, num_decoder_blocks=2, encoder_dim=32,
                decoder_dim=32, num_encoder_heads=2, num_decoder_heads=2,
                num_object_preds=16, num_categories=12, num_attributes=20,
                max_objects=8, compute_dtype="float32", dropout_rate=0.0)
B = 4


def test_unitwise_dims_follow_flax_layout():
    dims = tsteps.unitwise_dims
    assert dims("a.weight", torch.zeros(5, 7)) == (1,)  # Dense [in, out]
    assert dims("a.weight", torch.zeros(5, 7, 3, 3)) == (1, 2, 3)  # HWIO
    assert dims("a.weight", torch.zeros(5, 1, 3, 3)) == (1, 2, 3)  # depthwise
    assert dims("positional_encoding", torch.zeros(9, 4)) == (0,)
    # at most one axis longer than 1: the whole tensor (optax's squeeze)
    assert dims("a.weight", torch.zeros(6, 1, 1, 1)) == (0, 1, 2, 3)
    for leaf in ("skip_gain", "bias", "gain", "weight"):
        shape = () if leaf == "skip_gain" else (5,)
        assert dims(f"a.{leaf}", torch.zeros(shape)) is None


@pytest.mark.parametrize("shape", [(6, 5), (1, 1, 4, 7), (3, 3, 1, 8),
                                   (8, 3), (1, 1, 1, 6), (3, 3, 4, 1)])
def test_adaptive_grad_clip_matches_optax(shape):
    # a Flax-layout leaf and its gradient, some units above the clip and
    # some below, through optax and through the port in the port's layout
    rng = np.random.default_rng(0)
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * rng.uniform(0.001, 0.2, shape[-1:])
         ).astype(np.float32)
    tx = optax.adaptive_grad_clip(0.05)
    ref, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(p)),
                       jnp.asarray(p))
    if len(shape) == 2:  # Dense [in, out] -> Linear [out, in]
        name, to_port, back = "d.weight", np.transpose, np.transpose
    else:  # HWIO -> OIHW
        name = "c.weight"
        to_port = lambda a: a.transpose(3, 2, 0, 1)  # noqa: E731
        back = lambda a: a.transpose(2, 3, 1, 0)  # noqa: E731
    param = torch.nn.Parameter(torch.from_numpy(to_port(p).copy()))
    param.grad = torch.from_numpy(to_port(g).copy())
    tsteps.adaptive_grad_clip(
        [(param, tsteps.unitwise_dims(name, param))], 0.05)
    out = back(param.grad.numpy())
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-9)
    assert not np.allclose(out, g)  # some unit was clipped


def test_agc_never_clips_skip_gain_biases_or_scales():
    model = bt.DETR(bt.ModelConfig(**SKIPINIT), device="cpu")
    names = {id(p): n for n, p in model.named_parameters()}
    opt = bt.make_optimizer(bt.TrainConfig(agc_clip=1e-6, clipnorm=0.0),
                            model.named_parameters())
    clipped = {names[id(p)] for p, _ in opt.agc}
    for n, p in model.named_parameters():
        assert (n in clipped) == (p.dim() >= 2), n
    assert any(n.endswith("skip_gain") for n in names.values())
    # gradients of ones: every clipped unit comes out small, every other
    # leaf keeps its ones
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    tsteps.adaptive_grad_clip(list(opt.agc), 1e-6)
    for n, p in model.named_parameters():
        if n in clipped:
            assert p.grad.abs().max() < 1e-2, n
        else:
            assert torch.equal(p.grad, torch.ones_like(p)), n
    with pytest.raises(ValueError, match="named_parameters"):
        bt.make_optimizer(bt.TrainConfig(agc_clip=0.05), model.parameters())


def test_agc_composes_with_the_trainable_mask():
    model = bt.DETR(bt.ModelConfig(**SKIPINIT), device="cpu")
    mask = {n: n.startswith("backbone.") for n, _ in model.named_parameters()}
    opt = bt.make_optimizer(bt.TrainConfig(agc_clip=1e-6, clipnorm=0.0),
                            model.named_parameters(), trainable_mask=mask)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt.step()
    for n, p in model.named_parameters():
        if not mask[n]:  # not held: no clip, no update
            assert torch.equal(p.grad, torch.ones_like(p)), n
            assert torch.equal(p.detach(), before[n]), n
        elif p.dim() >= 2:
            assert p.grad.abs().max() < 1e-2, n


def _batch(rng):
    return {"image": rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
            "category_ids": rng.integers(2, 12, (B, 8)).astype(np.int32),
            "attribute_ids": rng.integers(0, 20, (B, 8, 4)).astype(np.int32),
            "bbox": rng.uniform(0.05, 0.45, (B, 8, 4)).astype(np.float32),
            "num_objects": rng.integers(1, 9, (B,)).astype(np.int32)}


def _capture_raw_grads():
    """An optax stage that keeps the raw gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def reference():
    """One JAX train step of the skipinit DETR with ``agc_clip=0.05`` from
    drawn weights (no BatchNorm anywhere: no ``batch_stats``, and the step
    is deterministic at dropout 0)."""
    batch = _batch(np.random.default_rng(1))
    jcfg = jconfig.ModelConfig(**SKIPINIT, matcher="hungarian")
    jmodel = JaxDETR(jcfg)
    variables = draw(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                    batch["image"]),
                     np.random.default_rng(2))
    assert set(variables) == {"params"}
    tcfg = jconfig.TrainConfig(batch_size=B, agc_clip=0.05)
    tx = optax.chain(_capture_raw_grads(),
                     jsteps.make_optimizer(tcfg, d_model=32))
    state = jsteps.TrainState.create(_jax(variables["params"]), {}, tx)
    step = jax.jit(jsteps.make_train_step(jmodel, jcfg, tcfg))
    new_state, aux = step(state, _jax(batch), jax.random.PRNGKey(2))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return {"batch": batch, "variables": variables, "aux": to_np(aux),
            "grads": to_np(new_state.opt_state[0]),
            "params": to_np(new_state.params)}


def test_skipinit_step_with_agc_matches_jax(reference, monkeypatch):
    # the tight regime of tests/test_torch_train.py: with no batch
    # statistics nothing amplifies the float32 rounding
    tol = STEP_TOL["frozen"]
    ref = reference
    model = bt.DETR(bt.ModelConfig(**SKIPINIT, matcher="pallas"),
                    device="cpu")
    bt.load_flax_variables(model, ref["variables"])
    raw, clipped = {}, []
    agc = tsteps.adaptive_grad_clip

    def capture(units, clip):  # the raw gradients, before any clip
        raw.update({n: p.grad.clone() for n, p in model.named_parameters()})
        agc(units, clip)
        clipped.extend(n for n, p in model.named_parameters()
                       if not torch.equal(p.grad, raw[n]))

    monkeypatch.setattr(tsteps, "adaptive_grad_clip", capture)
    tcfg = bt.TrainConfig(batch_size=B, agc_clip=0.05)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=32))
    state, aux = bt.make_train_step(model, model.config, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in ref["batch"].items()})
    assert set(aux) == set(ref["aux"])
    for k in ref["aux"]:
        np.testing.assert_allclose(aux[k].item(), float(ref["aux"][k]),
                                   rtol=tol["loss"], atol=1e-6, err_msg=k)
    grads = bt.to_flax_layout(model, raw)["params"]
    _assert_trees_close(grads, ref["grads"], tol["rel"], "grad", tol["floor"])
    # the clip engaged on some kernels, never on skip_gain or a gain
    assert clipped and not any(n.endswith(("skip_gain", "gain", "bias"))
                               for n in clipped)
    new = bt.to_flax_layout(model, model.state_dict())
    assert set(new) == {"params"}
    _assert_trees_close(new["params"], ref["params"], tol["param"],
                        "new param")
    moved = [k for k, v in _leaves(ref["params"])
             if k.endswith("skip_gain")
             and not np.array_equal(v, dict(_leaves(
                 ref["variables"]["params"]))[k])]
    assert moved  # skip_gain trains, unclipped


@pytest.mark.parametrize("cfg", ["skipinit", "tiny_groupnorm"])
def test_norm_free_and_groupnorm_leaves_round_trip(reference, cfg):
    """``load_flax_variables`` then ``to_flax_layout`` gives back every
    leaf bit for bit: ``conv/gain``, ``skip_gain`` (shape ()), the neck's
    and the tiny backbone's ``norm/gn/{scale,bias}``."""
    if cfg == "skipinit":
        kw, variables = SKIPINIT, reference["variables"]
    else:
        kw = dict(SKIPINIT, backbone="tiny", backbone_width=0.25,
                  norm="groupnorm", use_pallas_stem=False)
        variables = draw(jax.eval_shape(
            JaxDETR(jconfig.ModelConfig(**kw)).init, jax.random.PRNGKey(0),
            jnp.zeros((1, 64, 64, 3))), np.random.default_rng(3))
    model = bt.DETR(bt.ModelConfig(**kw), device="cpu")
    bt.load_flax_variables(model, variables)
    back = bt.to_flax_layout(model, model.state_dict())
    assert set(back) == set(variables) == {"params"}
    ours, want = dict(_leaves(back["params"])), dict(
        _leaves(variables["params"]))
    assert set(ours) == set(want)
    for name, w in want.items():
        assert ours[name].shape == w.shape, name
        np.testing.assert_array_equal(ours[name], w, err_msg=name)
    names = " ".join(want)
    if cfg == "skipinit":
        assert "stem/conv/gain" in names and "block0/skip_gain" in names
        assert "neck/norm1/gn/scale" in names
    else:
        assert "tiny/conv4/norm/gn/scale" in names
