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
                                   (3, 4, 8), (2, 100, 120)])
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
def test_kernel_ends_on_nan_costs(cuda):
    cost = torch.full((2, 3, 4), float("nan"), device=cuda)
    out = lap.hungarian_lap(cost, torch.tensor([3, 1], device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (2, 3, 4)


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_hold(cuda):
    cost = torch.zeros((1, 40, 216), device=cuda)  # 257 columns
    before = lap.hungarian_lap.launches
    with pytest.raises(ValueError, match="columns"):
        lap.hungarian_lap(cost, torch.tensor([1], device=cuda))
    assert lap.hungarian_lap.launches == before
