"""The port's approximate matchers and host oracle
(boosted_detr_torch/ops/matching.py: ``auction_lap``, ``greedy_lap``,
``hungarian_host``, ``solve_matching``) against the JAX package's and
scipy on the CPU: the auction's mask against JAX's and within n*eps of
scipy's total cost; greedy bit for bit unshuffled, and by property when a
generator shuffles it; the host oracle against scipy; each matcher through
``matching_loss`` against JAX's. Costs are random floats (tie-free) unless
a test says otherwise; n = 0 and n = O problems are included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from boosted_detr_torch.ops import matching as tm
from boosted_detr_tpu.ops import matching as jm

torch.set_num_threads(2)

SHAPES = [(4, 5, 9), (3, 8, 8), (2, 32, 96)]


def _problem(b, o, p, seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # a few distinct values: ties everywhere
        cost = rng.integers(0, 3, (b, o, p)).astype(np.float32)
    else:
        cost = rng.uniform(0.0, 10.0, (b, o, p)).astype(np.float32)
    n = rng.integers(1, o + 1, (b,)).astype(np.int32)
    n[0], n[-1] = 0, o
    return cost, n


def _valid(mask, n):
    for i, ni in enumerate(n):
        assert (mask[i, :ni].sum(1) == 1).all()
        assert (mask[i, ni:] == 0).all()
        assert (mask[i].sum(0) <= 1).all()


def _scipy_cost(cost, n):
    out = []
    for i, ni in enumerate(n):
        r, c = linear_sum_assignment(cost[i, :ni]) if ni else ([], [])
        out.append(cost[i][r, c].sum() if ni else 0.0)
    return np.asarray(out)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b,o,p", SHAPES)
def test_auction_matches_jax_and_scipy_within_n_eps(b, o, p, ties):
    """The same bids, the same first-maximum tie rule and the same eviction:
    JAX's mask bit for bit; the total cost within n * eps of the optimum,
    eps = 1e-2 * spread / (n + 1)."""
    cost, n = _problem(b, o, p, seed=o * p, ties=ties)
    got = tm.auction_lap(torch.from_numpy(cost), torch.from_numpy(n)).numpy()
    want = np.asarray(jm.auction_lap(jnp.asarray(cost), jnp.asarray(n)))
    np.testing.assert_array_equal(got, want)
    _valid(got, n)
    total = (got * cost).sum((1, 2))
    spread = np.array([np.ptp(cost[i, :max(ni, 1)]) for i, ni in
                       enumerate(n)])
    eps = 1e-2 * np.maximum(spread, 1e-6) / (n + 1.0)
    assert (total - _scipy_cost(cost, n) <= n * eps + 1e-4).all()


def test_auction_round_cap_stops_it():
    """``max_rounds`` caps the bidding: with one round, each object holds
    at most the one prediction it won, none twice."""
    cost, n = _problem(2, 6, 6, seed=1, ties=True)
    mask = tm.auction_lap(torch.from_numpy(cost), torch.from_numpy(n),
                          max_rounds=1).numpy()
    want = np.asarray(jm.auction_lap(jnp.asarray(cost), jnp.asarray(n),
                                     max_rounds=1))
    np.testing.assert_array_equal(mask, want)
    assert (mask.sum(1) <= 1).all() and (mask.sum(2) <= 1).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("b,o,p", SHAPES)
def test_greedy_unshuffled_is_jax_bit_for_bit(b, o, p, ties):
    cost, n = _problem(b, o, p, seed=o + p, ties=ties)
    got = tm.greedy_lap(torch.from_numpy(cost), torch.from_numpy(n)).numpy()
    want = np.asarray(jm.greedy_lap(jnp.asarray(cost), jnp.asarray(n)))
    np.testing.assert_array_equal(got, want)
    _valid(got, n)


def test_greedy_shuffled_takes_the_cheapest_free_prediction_in_its_order():
    """With a generator, each problem's rows go in the order of one
    ``randperm`` drawn from it, and each active row takes its cheapest
    prediction not yet taken: replayed here from a generator with the same
    seed. The same seed gives the same mask."""
    b, o, p = 4, 8, 12
    cost, n = _problem(b, o, p, seed=5)
    ct, nt = torch.from_numpy(cost), torch.from_numpy(n)
    mask = tm.greedy_lap(ct, nt, torch.Generator().manual_seed(3)).numpy()
    again = tm.greedy_lap(ct, nt, torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(mask, again)
    _valid(mask, n)
    replay = torch.Generator().manual_seed(3)
    orders = [torch.randperm(o, generator=replay).numpy() for _ in range(b)]
    for i in range(b):
        taken = np.zeros(p, bool)
        for row in orders[i]:
            if row >= n[i]:
                continue
            col = int(np.argmax(mask[i, row]))
            free = np.where(taken, np.inf, cost[i, row])
            assert cost[i, row, col] == free.min()
            taken[col] = True
    # every row prefers the same columns: the order decides who gets them
    rank = np.arange(p, dtype=np.float32) + 0.01 * cost
    shuffled = [tm.greedy_lap(torch.from_numpy(rank), nt,
                              torch.Generator().manual_seed(s)).numpy()
                for s in range(4)]
    assert any(not np.array_equal(m, shuffled[0]) for m in shuffled[1:])


@pytest.mark.parametrize("b,o,p", SHAPES)
def test_hungarian_host_is_scipy(b, o, p):
    cost, n = _problem(b, o, p, seed=7 * o)
    mask = tm.hungarian_host(torch.from_numpy(cost), torch.from_numpy(n))
    assert mask.dtype == torch.float32 and mask.device.type == "cpu"
    mask = mask.numpy()
    for i, ni in enumerate(n):
        want = np.zeros((o, p), np.float32)
        if ni:
            r, c = linear_sum_assignment(cost[i, :ni])
            want[r, c] = 1.0
        np.testing.assert_array_equal(mask[i], want)
    exact = tm.solve_matching(torch.from_numpy(cost), torch.from_numpy(n),
                              "hungarian").numpy()
    np.testing.assert_array_equal(mask, exact)  # tie-free: one optimum


def _loss_problem(rng, b=3, o=4, p=10, vc=7, va=5):
    cat = np.eye(vc, dtype=np.float32)[rng.integers(2, vc, (b, o))]
    att = (rng.uniform(size=(b, o, va)) < 0.3).astype(np.float32)
    bbox = rng.uniform(0.05, 0.45, (b, o, 4)).astype(np.float32)
    n = np.array([0, 2, o], np.int32)
    logits = rng.standard_normal((b, p, vc)).astype(np.float32)
    cat_p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    att_p = rng.uniform(0.01, 0.99, (b, p, va)).astype(np.float32)
    box_p = rng.uniform(0.0, 0.6, (b, p, 4)).astype(np.float32)
    return cat, att, bbox, n, cat_p.astype(np.float32), att_p, box_p


@pytest.mark.parametrize("matcher", ["auction", "greedy", "hungarian_host"])
def test_matchers_through_matching_loss_match_jax(matcher):
    args = _loss_problem(np.random.default_rng(11))
    losses, metrics, mask = tm.matching_loss(
        *(torch.from_numpy(a) for a in args), matcher=matcher,
        return_assignment=True)
    jlosses, jmetrics, jmask = jm.matching_loss(
        *(jnp.asarray(a) for a in args), matcher=matcher,
        return_assignment=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    for k in jlosses:
        np.testing.assert_allclose(losses[k].numpy(), np.asarray(jlosses[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(metrics["iou"].numpy(),
                               np.asarray(jmetrics["iou"]), rtol=1e-5,
                               atol=1e-6)
