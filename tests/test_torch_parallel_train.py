"""Data parallelism across processes (parallel/mesh.py, the train step's
gradient all-reduce, the synced BatchNorm, the global normalisers and the
global random draws) on the CPU: two gloo ranks, each on 4 of the 8 rows
of a batch, against JAX's step on the whole batch (the dry run's tiny
DETR, weights drawn on ``jax.eval_shape``'s tree, float32), and against
the port's own one-process step where the two packages' random bits
cannot match (dropout 0.1) or JAX has no like step at hand (the boosted
fold of the intermediate losses, a panoptic step). Every rank must hold
the same results bit for bit.

Measured here, against JAX: with ``freeze_bn_stats`` and calibrated
statistics (the train=False forward) the losses agree to 9.3e-8 relative
and the whole gradient to 6.9e-7 of its norm; with live BatchNorm, synced
over the ranks, to 1.6e-6 and 2.3e-5 (the worst leaf 1.3e-5 of the whole
gradient's norm: this small backbone amplifies rounding far less than
tests/test_torch_train.py's ResNet). Two ranks against one: the whole
gradient within 4.1e-6 (dropout), 2.4e-5 (boosted) and 8.9e-6 (panoptic).
The tolerances sit several times above these."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tbackbone
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.train import steps as jsteps
from test_torch_boosted import tiny_variables
from test_torch_train import _assert_trees_close, _capture_raw_grads, _leaves
from torch_parallel_cases import run_ranks, same_on_every_rank, train_case

torch.set_num_threads(2)

B = 8
# the dry run's tiny config (a 4-layer CNN backbone: JAX compiles its step
# in a few seconds), with 20 attributes and up to 8 objects
TINY = dict(num_object_preds=16, image_size=(64, 64), num_encoder_blocks=2,
            num_encoder_heads=2, encoder_dim=32, num_decoder_blocks=2,
            num_decoder_heads=2, decoder_dim=32, num_categories=12,
            num_attributes=20, backbone="tiny", backbone_width=0.25,
            compute_dtype="float32", max_objects=8, dropout_rate=0.0)
JAX_CFG = jconfig.ModelConfig(**TINY, matcher="hungarian")
PORT = dict(TINY, matcher="pallas")  # the plain solver on CPU tensors
# Per leaf ||ours - ref|| <= rel ||ref leaf|| + floor ||ref tree||, the
# whole gradient within ``whole`` of its norm, the new parameters within
# ``param`` of each leaf's norm; measured (see the module docstring).
TOL = {"frozen": dict(loss=1e-5, rel=1e-4, floor=1e-6, whole=1e-4,
                      param=1e-6),
       "live": dict(loss=1e-5, rel=0.0, floor=1e-4, whole=2e-4,
                    param=1e-6)}


def _batch(seed, masks=False):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
             "category_ids": rng.integers(2, 12, (B, 8)).astype(np.int32),
             "attribute_ids": rng.integers(0, 20, (B, 8, 4)).astype(np.int32),
             "bbox": rng.uniform(0.05, 0.45, (B, 8, 4)).astype(np.float32),
             "num_objects": rng.integers(0, 9, (B,)).astype(np.int32)}
    if masks:
        batch["masks"] = (rng.uniform(0, 1, (B, 8, 16, 16)) > 0.5).astype(
            np.float32)
    return batch


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _calibrated(variables, image):
    """``variables`` with running statistics that normalise ``image``: its
    own batch means and its batch variances plus 1 (as
    tests/test_torch_train.py::_calibrated)."""
    model = bt.DETR(bt.ModelConfig(**PORT), device="cpu")
    bt.load_flax_variables(model, variables)
    model.train()
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
    """JAX's ``make_train_step`` on the whole batch, once at live and once
    at frozen (calibrated) statistics, with the raw gradients kept."""
    batch = _batch(0)
    jmodel = JaxDETR(JAX_CFG)
    variables = _to_np(tiny_variables(jmodel, batch["image"], seed=1))
    ref = {"batch": batch}
    for regime in ("live", "frozen"):
        start = (_calibrated(variables, batch["image"])
                 if regime == "frozen" else variables)
        svars = jax.tree_util.tree_map(jnp.asarray, start)
        tcfg = jconfig.TrainConfig(batch_size=B,
                                   freeze_bn_stats=regime == "frozen")
        tx = optax.chain(_capture_raw_grads(),
                         jsteps.make_optimizer(tcfg, d_model=32))
        state = jsteps.TrainState.create(svars["params"],
                                         svars["batch_stats"], tx)
        step = jax.jit(jsteps.make_train_step(jmodel, JAX_CFG, tcfg))
        new, aux = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(2))
        ref[regime] = {"variables": start, "aux": _to_np(aux),
                       "grads": _to_np(new.opt_state[0]),
                       "params": _to_np(new.params),
                       "batch_stats": _to_np(new.batch_stats)}
    return ref


@pytest.fixture(scope="module")
def cases(reference):
    batch = reference["batch"]
    detr = dict(model="detr", cfg=PORT, batch=batch)
    return {
        "frozen": dict(detr, variables=reference["frozen"]["variables"],
                       train=dict(batch_size=B, freeze_bn_stats=True)),
        "live": dict(detr, variables=reference["live"]["variables"],
                     train=dict(batch_size=B)),
        "dropout": dict(detr, variables=reference["live"]["variables"],
                        cfg=dict(PORT, dropout_rate=0.1),
                        train=dict(batch_size=B)),
        "boosted": dict(model="boosted", cfg=PORT, seed=1,
                        batch=_batch(3), train=dict(
                            batch_size=B, freeze_bn_stats=True,
                            use_intermediate_losses=True)),
        "panoptic": dict(model="panoptic", cfg=PORT, seed=2, mask_size=16,
                         batch=_batch(4, masks=True),
                         train=dict(batch_size=B)),
    }


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Both ranks' results of every case, checked equal bit for bit."""
    results = run_ranks("train_cases", {"cases": cases}, 2,
                        tmp_path_factory.mktemp("train"))
    return {name: same_on_every_rank([r[name] for r in results])
            for name in cases}


def _flax(result, key="grads"):
    model = bt.DETR(bt.ModelConfig(**PORT), device="cpu")
    return bt.to_flax_layout(model, {k: torch.from_numpy(v)
                                     for k, v in result[key].items()})


def _whole(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    return np.sqrt(sum(np.sum(np.square(got[k] - want[k])) for k in want)
                   / sum(np.sum(np.square(w)) for w in want.values()))


@pytest.mark.parametrize("regime", ["frozen", "live"])
def test_two_ranks_match_jax_on_the_global_batch(reference, ranks, regime):
    tol = TOL[regime]
    ref = reference[regime]
    got = ranks[regime]
    assert set(got["aux"]) == set(ref["aux"])
    for k, want in ref["aux"].items():
        np.testing.assert_allclose(got["aux"][k], float(want),
                                   rtol=tol["loss"], atol=1e-6, err_msg=k)
    grads = _flax(got)["params"]
    _assert_trees_close(grads, ref["grads"], tol["rel"], "grad",
                        tol["floor"])
    assert _whole(grads, ref["grads"]) <= tol["whole"]
    state = _flax(got, "state")
    _assert_trees_close(state["params"], ref["params"], tol["param"],
                        "new param")
    # every rank's running statistics are the global batch's
    _assert_trees_close(state["batch_stats"], ref["batch_stats"], 1e-5,
                        "new running stat")


@pytest.mark.parametrize("name", ["dropout", "boosted", "panoptic"])
def test_two_ranks_match_one_rank(cases, ranks, name):
    """Dropout draws the global batch's bits (each rank keeps its rows),
    and the boosted fold's rescale and the mask loss take the global
    ``1 + sum(num_objects)``: two ranks of B/2 rows equal one of B."""
    want = train_case(cases[name], None)
    got = ranks[name]
    tol = TOL["live" if name != "boosted" else "frozen"]
    assert set(got["aux"]) == set(want["aux"])
    for k, w in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k], w, rtol=tol["loss"],
                                   atol=1e-6, err_msg=k)
    assert _whole({"g": got["grads"]}, {"g": want["grads"]}) <= tol["whole"]
