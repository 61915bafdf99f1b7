"""The hand-written CUDA kernel of the exact matcher
(boosted_detr_torch/csrc/lap.cu) against its plain PyTorch version and
scipy on the card. It needs a CUDA card and nvcc, and skips without a card.
It imports nothing of JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_lap_kernel.py
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from boosted_detr_torch.ops import lap

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _solve_both(cuda, cost, n):
    c = torch.from_numpy(cost).to(cuda)
    nt = torch.from_numpy(n).to(cuda)
    before = lap.hungarian_lap.launches
    got = lap.hungarian_lap(c, nt)
    torch.cuda.synchronize()
    assert lap.hungarian_lap.launches == before + 1
    want = lap.hungarian_lap_reference(c, nt)
    return got.cpu().numpy(), want.cpu().numpy()


def _check_optimal(mask, cost, n):
    """Valid assignment of the first n rows, zero elsewhere, at scipy's
    total cost (rtol 1e-5, atol 1e-3: the JAX kernel test's tolerance)."""
    for i in range(cost.shape[0]):
        ni = int(n[i])
        assert (mask[i, ni:] == 0).all()
        assert (mask[i].sum(0) <= 1).all()
        if ni:
            assert (mask[i, :ni].sum(1) == 1).all()
            r, c = linear_sum_assignment(cost[i, :ni])
            assert np.isclose((mask[i] * cost[i]).sum(), cost[i][r, c].sum(),
                              rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,o,p", [(8, 32, 96),    # the flagship
                                   (32, 32, 96),   # four blocks folded
                                   (3, 4, 8), (2, 100, 120),
                                   (8, 32, 300),   # num_object_preds=300
                                   (4, 120, 300),  # the most rows
                                   (2, 32, 990),   # C = 1023
                                   (3, 7, 33)])    # O * P % 4 != 0
def test_kernel_matches_plain_version(cuda, b, o, p):
    rng = np.random.default_rng(b * 1000 + o)
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = rng.integers(1, o + 1, (b,)).astype(np.int32)
    n[0], n[-1] = 0, o  # no objects, and every row taking part
    got, want = _solve_both(cuda, cost, n)
    _check_optimal(got, cost, n)
    # the same float32 arithmetic, step for step: the same mask
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_kernel_on_mixed_scales_and_ties(cuda):
    rng = np.random.default_rng(7)
    cost = (1000 * rng.uniform(0, 0.09, (4, 16, 32))
            - 50 * rng.uniform(0, 1, (4, 16, 32))).astype(np.float32)
    n = np.array([16, 7, 0, 1], np.int32)
    got, want = _solve_both(cuda, cost, n)
    _check_optimal(got, cost, n)
    np.testing.assert_array_equal(got, want)
    # integer costs are full of ties: any optimum will do, and the lowest
    # index rule makes both versions pick the same one
    ties = rng.integers(0, 3, (4, 8, 12)).astype(np.float32)
    n = np.array([8, 8, 5, 3], np.int32)
    got, want = _solve_both(cuda, ties, n)
    _check_optimal(got, ties, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_kernel_ties_minus_zero_with_plus_zero(cuda):
    # the float compare holds -0.0 == +0.0, so the lowest column wins the
    # tie (torch.min's rule), whichever sign it has; an argmin on the raw
    # bits would take the -0.0
    for row in ([1.0, 0.0, 5.0, -0.0], [1.0, -0.0, 5.0, 0.0]):
        cost = np.array([[row]], np.float32)
        got, want = _solve_both(cuda, cost, np.array([1], np.int32))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0, 0], [0.0, 1.0, 0.0, 0.0])
    # signed zeros all over: ties in every step, a mask equal to the plain
    # version's on the CPU
    rng = np.random.default_rng(12)
    cost = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0], np.float32),
                      (4, 12, 20))
    n = np.array([12, 5, 0, 9], np.int32)
    got, _ = _solve_both(cuda, cost, n)
    _check_optimal(got, cost, n)
    np.testing.assert_array_equal(got, lap.hungarian_lap_reference(
        torch.from_numpy(cost), torch.from_numpy(n)).numpy())


@pytest.mark.gpu
def test_kernel_ends_on_nan_costs(cuda):
    cost = torch.full((2, 3, 4), float("nan"), device=cuda)
    out = lap.hungarian_lap(cost, torch.tensor([3, 1], device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (2, 3, 4)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_hold(cuda):
    # O > 120 is the TPU kernel's own limit; every P is taken (the columns
    # route below)
    before = lap.hungarian_lap.launches
    cost = torch.zeros((1, 121, 8), device=cuda)
    with pytest.raises(ValueError, match="rows"):
        lap.hungarian_lap(cost, torch.tensor([1], device=cuda))
    assert lap.hungarian_lap.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,o,p,route", [
    (8, 120, 900, "columns"),          # DINO's 900 queries, 120 objects
    (2, 64, 2000, "columns"),          # C = 2065
    (2, 32, 992, "columns"),           # C = 1025
    (3, 7, 1101, "columns"),           # O * P % 4 != 0
    (2, 8, 20000, "columns_global"),   # the column state in device memory
])
def test_columns_route_matches_plain_version(cuda, b, o, p, route):
    assert lap.kernel_plan(o, p).route == route
    rng = np.random.default_rng(b * 1000 + o + p)
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = rng.integers(1, o + 1, (b,)).astype(np.int32)
    n[0], n[-1] = 0, o
    got, want = _solve_both(cuda, cost, n)
    _check_optimal(got, cost, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,o,p,slots", [
    # C one below, at and one above a multiple of the block's 256 threads,
    # where the register slots a thread change: 3 | 4, 4 | 6, 8 | 10
    (2, 120, 646, 3), (2, 120, 647, 3), (2, 120, 648, 4),
    (3, 120, 902, 4), (3, 120, 903, 4), (3, 120, 904, 6),
    (2, 120, 1926, 8), (2, 120, 1927, 8), (2, 120, 1928, 10),
    # the most columns in registers, then the column state in device memory
    (2, 120, 3975, 16), (2, 120, 3976, 0),
    # one row
    (3, 1, 1100, 6), (2, 1, 4094, 16), (2, 1, 4095, 0),
])
def test_columns_route_at_the_slot_edges(cuda, b, o, p, slots):
    plan = lap.kernel_plan(o, p)
    assert plan.route.startswith("columns") and plan.slots == slots
    rng = np.random.default_rng(o * 7 + p)
    cost = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n = rng.integers(1, o + 1, (b,)).astype(np.int32)
    n[0], n[-1] = 0, o  # no objects, and every row taking part
    got, want = _solve_both(cuda, cost, n)
    _check_optimal(got, cost, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_columns_route_on_ties(cuda):
    # integer costs: ties in every step, which the lowest-column rule
    # breaks as the plain version does
    rng = np.random.default_rng(13)
    cost = rng.integers(0, 3, (3, 16, 1100)).astype(np.float32)
    n = np.array([16, 9, 1], np.int32)
    got, want = _solve_both(cuda, cost, n)
    _check_optimal(got, cost, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("o,p", [(120, 600), (4, 4500)])
def test_columns_route_ties_minus_zero_with_plus_zero(cuda, o, p):
    """The lowest column wins a tie of -0.0 with +0.0 on the columns
    route, in registers (120 x 600) and in device memory (C = 4505)."""
    assert lap.kernel_plan(o, p).route.startswith("columns")
    for first in ([1.0, 0.0, 5.0, -0.0], [1.0, -0.0, 5.0, 0.0]):
        cost = np.full((1, o, p), 9.0, np.float32)
        cost[0, 0, :4] = first
        got, want = _solve_both(cuda, cost, np.array([1], np.int32))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0, 0, :4], [0.0, 1.0, 0.0, 0.0])
    # signed zeros all over: ties in every step, a mask equal to the plain
    # version's on the CPU
    rng = np.random.default_rng(o + p)
    cost = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0], np.float32), (3, o, p))
    n = np.array([o, o // 2, 0], np.int32)
    got, _ = _solve_both(cuda, cost, n)
    _check_optimal(got, cost, n)
    np.testing.assert_array_equal(got, lap.hungarian_lap_reference(
        torch.from_numpy(cost), torch.from_numpy(n)).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("o,p", [(120, 900), (8, 5000)])
def test_columns_route_ends_on_nan_costs(cuda, o, p):
    assert lap.kernel_plan(o, p).route.startswith("columns")
    cost = torch.full((2, o, p), float("nan"), device=cuda)
    before = lap.hungarian_lap.launches
    out = lap.hungarian_lap(cost, torch.tensor([o, 1], device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (2, o, p)
    assert lap.hungarian_lap.launches == before + 1


@pytest.mark.gpu
def test_library_states_the_wrappers_plan(cuda):
    lib = lap._library()
    for o in (1, 7, 32, 33, 100, 120):
        for p in (1, 8, 96, 120, 300, 480, 900, 990, 2000, 3975, 3976,
                  20000):
            plan = lap.kernel_plan(o, p)
            if plan.route == "slots":
                assert lib.lap_smem_bytes(o, p) == plan.smem
            else:
                assert lib.lap_columns_slots(o, p) == plan.slots
                assert lib.lap_columns_bytes(o, p) == plan.scratch


@pytest.mark.gpu
def test_train_step_with_300_queries_on_the_kernel(cuda):
    """num_object_preds=300, max_objects=32, matcher="pallas": C = 333,
    past the first kernel's 256 columns. One train step of a small float32
    model on the card through the kernel, against the same step from the
    same weights with the plain solver on the card
    (matcher="hungarian"): the same mask, so the same losses."""
    import boosted_detr_torch as bt

    cfg = bt.ModelConfig(image_size=(64, 64), backbone="resnet",
                         backbone_width=0.25, stem="patchify8",
                         use_pallas_stem=False, compute_dtype="float32",
                         num_encoder_blocks=1, num_decoder_blocks=1,
                         encoder_dim=32, decoder_dim=32,
                         num_object_preds=300, num_categories=12,
                         num_attributes=20, max_objects=32,
                         matcher="pallas", dropout_rate=0.0)
    rng = np.random.default_rng(5)
    batch = {
        "image": rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32),
        "category_ids": rng.integers(2, 12, (4, 32)).astype(np.int32),
        "attribute_ids": rng.integers(0, 20, (4, 32, 4)).astype(np.int32),
        "bbox": rng.uniform(0.05, 0.45, (4, 32, 4)).astype(np.float32),
        "num_objects": np.array([32, 1, 17, 0], np.int32),
    }
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    tcfg = bt.TrainConfig(batch_size=4)
    weights = bt.DETR(cfg, seed=2).state_dict()
    losses = {}
    for matcher, launched in (("pallas", 1), ("hungarian", 0)):
        model = bt.DETR(cfg.replace(matcher=matcher), seed=2)
        model.load_state_dict(weights)
        state = bt.TrainState.create(model, bt.make_optimizer(
            tcfg, model.parameters(), d_model=cfg.decoder_dim))
        before = lap.hungarian_lap.launches
        _, aux = bt.make_train_step(model, cfg.replace(matcher=matcher),
                                    tcfg)(state, batch)
        torch.cuda.synchronize()
        assert lap.hungarian_lap.launches == before + launched
        losses[matcher] = {k: v.item() for k, v in aux.items()}
    for k, want in losses["hungarian"].items():
        assert np.isfinite(want)
        # one forward, the same mask: only run-to-run differences of the
        # card's float32 sums, if any
        assert abs(losses["pallas"][k] - want) <= 1e-5 * max(abs(want),
                                                             1e-6)
