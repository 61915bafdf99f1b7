"""The port's exact matcher and matching loss (boosted_detr_torch/ops/{lap,
matching}.py, train/steps.py::compute_losses) against scipy and the JAX
package: the plain solver (the arithmetic the CUDA kernel repeats) against
``linear_sum_assignment`` and against the Pallas kernel run through the
interpreter, and ``matching_loss`` against the JAX one with its XLA solver
(``matcher="hungarian"``; the Pallas dispatch does not run on the CPU
outside interpret mode). Costs are random floats, so they are tie-free and
the optimal assignment is unique."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import boosted_detr_torch as bt
from boosted_detr_torch.ops import lap as tlap
from boosted_detr_torch.ops import matching as tm
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu.config import LossWeights as JaxWeights
from boosted_detr_tpu.config import ModelConfig as JaxConfig
from boosted_detr_tpu.ops import matching as jm
from boosted_detr_tpu.ops.pallas_lap import hungarian_lap_pallas
from boosted_detr_tpu.train import steps as jsteps

torch.set_num_threads(2)

# float32 losses of the same formulas on the same assignment: only the
# order of float32 sums differs (einsums over <= 20 classes, masked sums
# over O*P <= 128 pairs); 1e-5 relative covers it.
F32 = dict(atol=1e-5, rtol=1e-5)


def _check_optimal(mask, cost, n):
    """Valid assignment of the first n rows, zero elsewhere, at scipy's
    total cost (rtol 1e-5, atol 1e-3: the JAX kernel test's tolerance)."""
    for i in range(cost.shape[0]):
        ni = int(n[i])
        np.testing.assert_array_equal(mask[i, ni:], 0.0)
        np.testing.assert_array_equal(mask[i].sum(0) <= 1.0, True)
        if ni:
            np.testing.assert_array_equal(mask[i, :ni].sum(1), 1.0)
            r, c = linear_sum_assignment(cost[i, :ni])
            assert np.isclose((mask[i] * cost[i]).sum(), cost[i][r, c].sum(),
                              rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("b,o,p", [(2, 4, 8), (3, 8, 16), (4, 32, 96)])
def test_plain_solver_is_optimal(b, o, p):
    rng = np.random.default_rng(o)
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = rng.integers(0, o + 1, (b,)).astype(np.int32)
    mask = tlap.hungarian_lap_reference(torch.from_numpy(cost),
                                        torch.from_numpy(n))
    assert mask.dtype == torch.float32 and mask.shape == (b, o, p)
    _check_optimal(mask.numpy(), cost, n)


@pytest.mark.parametrize("b,o,p", [(2, 4, 8), (3, 6, 10)])
def test_plain_solver_gives_the_pallas_kernels_mask(b, o, p):
    # tie-free costs have one optimum, so the masks are identical
    rng = np.random.default_rng(10 + o)
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = np.array([o, 0, o // 2][:b], np.int32)
    ours = tlap.hungarian_lap_reference(torch.from_numpy(cost),
                                        torch.from_numpy(n)).numpy()
    ref = np.asarray(hungarian_lap_pallas(jnp.asarray(cost), jnp.asarray(n),
                                          interpret=True))
    np.testing.assert_array_equal(ours, ref)


def test_edge_cases_and_mixed_scales():
    rng = np.random.default_rng(3)
    b, o, p = 3, 16, 32
    cost = (1000 * rng.uniform(0, 0.09, (b, o, p))
            - 50 * rng.uniform(0, 1, (b, o, p))).astype(np.float32)
    n = np.array([0, o, 7], np.int32)  # none, all, some
    mask = tlap.hungarian_lap_reference(torch.from_numpy(cost),
                                        torch.from_numpy(n)).numpy()
    _check_optimal(mask, cost, n)
    assert mask[0].sum() == 0 and mask[1].sum() == o
    # O == P: every column is taken
    square = rng.uniform(0, 1, (2, 8, 8)).astype(np.float32)
    full = np.full(2, 8, np.int32)
    m = tlap.hungarian_lap_reference(torch.from_numpy(square),
                                     torch.from_numpy(full)).numpy()
    _check_optimal(m, square, full)
    np.testing.assert_array_equal(m.sum(1), 1.0)


def test_solver_ends_on_nan_costs():
    # the step caps end the search even where no comparison holds
    cost = torch.full((1, 3, 4), float("nan"))
    mask = tlap.hungarian_lap_reference(cost, torch.tensor([3]))
    assert mask.shape == (1, 3, 4)


def test_dispatch_and_launch_count():
    rng = np.random.default_rng(4)
    cost = torch.from_numpy(rng.uniform(0, 1, (2, 4, 8)).astype(np.float32))
    n = torch.tensor([4, 2], dtype=torch.int32)
    before = tlap.hungarian_lap.launches
    plain = tm.solve_matching(cost, n, "hungarian")
    for name in ("pallas", "hungarian_pallas"):
        np.testing.assert_array_equal(tm.solve_matching(cost, n, name), plain)
    assert tlap.hungarian_lap.launches == before  # CPU: the plain version
    # the approximate matchers and the host oracle: valid assignments of
    # the first n rows; the oracle at the exact solver's total cost
    for name in ("auction", "greedy", "hungarian_host"):
        mask = tm.solve_matching(cost, n, name).numpy()
        for i, ni in enumerate(n.tolist()):
            np.testing.assert_array_equal(mask[i].sum(1), [1] * ni + [0] * (
                4 - ni))
            assert (mask[i].sum(0) <= 1).all()
    np.testing.assert_allclose(
        (tm.solve_matching(cost, n, "hungarian_host") * cost).sum((1, 2)),
        (plain * cost).sum((1, 2)), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown matcher"):
        tm.solve_matching(cost, n, "nope")
    with pytest.raises(ValueError):
        tlap.hungarian_lap(cost, n[:1])


def _problem(rng, b, o, p, vc, va):
    cat = np.eye(vc, dtype=np.float32)[rng.integers(2, vc, (b, o))]
    att = (rng.uniform(size=(b, o, va)) < 0.2).astype(np.float32)
    bbox = rng.uniform(0.05, 0.45, (b, o, 4)).astype(np.float32)
    n = rng.integers(1, o + 1, (b,)).astype(np.int32)
    logits = rng.standard_normal((b, p, vc)).astype(np.float32)
    p_cat = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    p_att = rng.uniform(0, 1, (b, p, va)).astype(np.float32)
    p_box = rng.uniform(0.0, 0.5, (b, p, 4)).astype(np.float32)
    return cat, att, bbox, n, p_cat, p_att, p_box


@pytest.mark.parametrize("weights", [{}, dict(category=3.0, box=2.0,
                                              attribute=0.5, exist=7.0,
                                              giou=1.0, l2=3.0)])
def test_matching_loss_matches_jax(weights):
    rng = np.random.default_rng(5)
    arrays = _problem(rng, 3, 8, 16, 12, 20)
    losses, mets, mask = tm.matching_loss(
        *map(torch.from_numpy, arrays), weights=bt.LossWeights(**weights),
        matcher="pallas", return_assignment=True)
    ref_l, ref_m, ref_mask = jm.matching_loss(
        *map(jnp.asarray, arrays), weights=JaxWeights(**weights),
        matcher="hungarian", return_assignment=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert set(losses) == set(ref_l) == {"total", "category", "attribute",
                                         "box", "exist"}
    for k in losses:
        assert losses[k].shape == (3,)
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(ref_l[k]),
                                   **F32, err_msg=k)
    np.testing.assert_allclose(mets["iou"].numpy(), np.asarray(ref_m["iou"]),
                               **F32)


def test_matching_loss_gradient_skips_the_solver():
    rng = np.random.default_rng(6)
    arrays = [torch.from_numpy(a) for a in _problem(rng, 2, 4, 8, 12, 20)]
    for i in (4, 5, 6):
        arrays[i].requires_grad_(True)
    losses, _ = tm.matching_loss(*arrays)
    losses["total"].sum().backward()
    for i in (4, 5, 6):
        assert torch.isfinite(arrays[i].grad).all()
        assert arrays[i].grad.abs().sum() > 0


def _batch(rng, b, o, vc, va):
    return {"category_ids": rng.integers(2, vc, (b, o)).astype(np.int32),
            "attribute_ids": rng.integers(0, va, (b, o, 4)).astype(np.int32),
            "bbox": rng.uniform(0.05, 0.45, (b, o, 4)).astype(np.float32),
            "num_objects": rng.integers(0, o + 1, (b,)).astype(np.int32)}


def test_targets_from_batch_matches_jax():
    rng = np.random.default_rng(7)
    batch = _batch(rng, 2, 5, 12, 20)
    batch["category_ids"][0, 0] = 12  # out of range: a zero row
    ours = tsteps.targets_from_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 12, 20)
    ref = jsteps.targets_from_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, 12, 20)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_folded_compute_losses_matches_sequential_and_jax():
    rng = np.random.default_rng(8)
    b, o, p, vc, va, blocks = 2, 6, 12, 12, 20, 3
    batch = _batch(rng, b, o, vc, va)
    batch["num_objects"] = np.array([6, 3], np.int32)
    preds = []
    for _ in range(blocks):
        _, _, _, _, p_cat, p_att, p_box = _problem(rng, b, o, p, vc, va)
        preds.append({"category": p_cat, "attribute": p_att,
                      "boxes": p_box})
    cfg = dict(num_categories=vc, num_attributes=va, max_objects=o,
               num_object_preds=p)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tpreds = [{k: torch.from_numpy(v) for k, v in d.items()} for d in preds]
    tcfg = bt.ModelConfig(**cfg, matcher="pallas")
    fold, aux_fold = tsteps.compute_losses(tpreds, tbatch, tcfg,
                                           bt.LossWeights(), fold=True)
    seq, aux_seq = tsteps.compute_losses(tpreds, tbatch, tcfg,
                                         bt.LossWeights(), fold=False)
    # the fold rescales sums instead of adding per-block terms: float32
    # re-association only
    np.testing.assert_allclose(fold.item(), seq.item(), rtol=1e-5)
    for k in aux_seq:
        np.testing.assert_allclose(aux_fold[k].item(), aux_seq[k].item(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    ref, ref_aux = jsteps.compute_losses(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in preds],
        {k: jnp.asarray(v) for k, v in batch.items()}, JaxConfig(**cfg),
        JaxWeights(), fold=True)
    np.testing.assert_allclose(fold.item(), float(ref), **F32)
    assert set(aux_fold) == set(ref_aux)
    for k in ref_aux:
        np.testing.assert_allclose(aux_fold[k].item(), float(ref_aux[k]),
                                   **F32, err_msg=k)
