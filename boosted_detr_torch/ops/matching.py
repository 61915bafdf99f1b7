"""Bipartite matching and the DETR matching loss in PyTorch.

Counterpart of boosted_detr_tpu/ops/matching.py: ``hungarian_lap``
(:145-163), ``auction_lap`` (:178-265), ``greedy_lap`` (:268-308),
``hungarian_host`` (:311-345), ``solve_matching`` (:348-365) and
``matching_loss`` (:373-456). The solver runs on the device that holds the
cost: the exact solver of ops/lap.py, whose plain version serves
``"hungarian"`` and whose CUDA kernel serves ``"pallas"``; the auction and
the greedy matcher are plain torch on any device; ``hungarian_host`` is
scipy on the host, the oracle. Only the first ``num_objects[b]`` rows of
problem b take part; the mask is [B, max_objects, num_preds], float32, and
carries no gradient. Ties may resolve otherwise than another exact solver
would; any optimal assignment gives the same loss.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from boosted_detr_torch.config import LossWeights
from boosted_detr_torch.ops import lap
from boosted_detr_torch.ops import losses as loss_ops
from boosted_detr_torch.parallel import mesh as mesh_lib

_NEG = -1e30
_INF = 1e30

# The exact solver of any device; on a CUDA tensor ``matcher="pallas"``
# takes the kernel through ``lap.hungarian_lap`` instead.
hungarian_lap = lap.hungarian_lap_reference


def _one_hot_rows(assign: torch.Tensor, valid_row: torch.Tensor,
                  p: int) -> torch.Tensor:
    """[B, O] columns (-1: none) -> the float32 0/1 mask [B, O, P], zero
    on the rows that do not take part."""
    cols = torch.arange(p, device=assign.device)
    mask = (assign[..., None] == cols) & valid_row[..., None]
    return mask.float()


def auction_lap(cost: torch.Tensor, num_objects: torch.Tensor,
                eps_rel: float = 1e-2, max_rounds: int = 2000
                ) -> torch.Tensor:
    """The single-phase Jacobi auction from zero prices (matching.py:178).

    Each round every unassigned object bids for its best prediction
    (benefit ``-cost`` less the price) by the gap to its second best plus
    ``eps = eps_rel * spread / (n + 1)``; each prediction goes to its
    highest bidder (the first on a tie), whose price becomes the bid, and
    evicts its previous owner. Rounds run until every active row holds a
    prediction or ``max_rounds`` pass. The assignment's total cost is
    within ``n * eps`` of the optimum. On a CUDA tensor each round reads
    one flag back to the host."""
    cost = cost.detach().float()
    b, o, p = cost.shape
    dev = cost.device
    n = num_objects.reshape(b).to(device=dev, dtype=torch.int32)
    benefit = -cost
    row_ids = torch.arange(o, device=dev, dtype=torch.int32)
    col_ids = torch.arange(p, device=dev, dtype=torch.int32)
    valid_row = row_ids[None, :] < n[:, None]  # [B, O]

    vmask = valid_row[..., None]
    neg = torch.tensor(_NEG, device=dev)
    max_b = torch.where(vmask, benefit, neg).amax(dim=(1, 2))
    min_b = torch.where(vmask, benefit, -neg).amin(dim=(1, 2))
    spread = torch.clamp(max_b - min_b, min=1e-6)
    eps = eps_rel * spread / (n.float() + 1.0)  # [B]

    prices = torch.zeros((b, p), device=dev)
    assign = torch.full((b, o), -1, device=dev, dtype=torch.int32)
    for _ in range(max_rounds):
        if bool(((assign >= 0) | ~valid_row).all()):
            break
        unassigned = (assign < 0) & valid_row
        values = benefit - prices[:, None, :]  # [B, O, P]
        best_j = values.argmax(dim=2).to(torch.int32)  # first maximum
        is_best = col_ids[None, None, :] == best_j[..., None]
        v1 = values.amax(dim=2)
        v2 = torch.where(is_best, neg, values).amax(dim=2)
        bid = (prices.gather(1, best_j.long()) + (v1 - v2)) + eps[:, None]
        # per prediction the highest bidder wins
        bid_mat = torch.where(unassigned[..., None] & is_best,
                              bid[..., None], neg)  # [B, O, P]
        win_val = bid_mat.amax(dim=1)  # [B, P]
        win_obj = bid_mat.argmax(dim=1).to(torch.int32)
        has_winner = win_val > _NEG / 2
        prices = torch.where(has_winner, win_val, prices)
        # the previous owners of re-auctioned predictions are evicted
        col_of = torch.where(assign >= 0, assign, p).long()
        evicted = torch.cat([has_winner, has_winner.new_zeros((b, 1))],
                            dim=1).gather(1, col_of)
        assign = torch.where(evicted, -1, assign)
        # object i wins prediction j iff j has a winner and it is i
        won = (win_obj[:, :, None] == row_ids[None, None, :]) \
            & has_winner[:, :, None]  # [B, P, O]
        win_of_obj = torch.where(won, col_ids[None, :, None], -1).amax(dim=1)
        assign = torch.where(win_of_obj >= 0, win_of_obj, assign)
    return _one_hot_rows(assign, valid_row, p)


def greedy_lap(cost: torch.Tensor, num_objects: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy assignment (matching.py:268): the objects, in row order or
    in an order shuffled per problem, each take their cheapest prediction
    still free (the first on a tie). ``generator`` draws the shuffled
    orders (one ``randperm`` a problem on the generator's device); JAX's
    ``shuffle_key`` stream cannot be matched. Fast and approximate."""
    cost = cost.detach().float()
    b, o, p = cost.shape
    dev = cost.device
    n = num_objects.reshape(b).to(device=dev, dtype=torch.int64)
    row_ids = torch.arange(o, device=dev)
    valid_row = row_ids[None, :] < n[:, None]
    if generator is None:
        order = row_ids[None, :].expand(b, o)
    else:
        order = torch.stack([
            torch.randperm(o, generator=generator, device=generator.device)
            for _ in range(b)]).to(dev)
    batch = torch.arange(b, device=dev)
    assign = torch.full((b, o), -1, device=dev, dtype=torch.int64)
    used = torch.zeros((b, p), device=dev, dtype=torch.bool)
    for i in range(o):
        obj = order[:, i]
        active = valid_row[batch, obj]
        c_row = torch.where(used, _INF, cost[batch, obj])  # [B, P]
        j = c_row.argmin(dim=1)  # first minimum
        used[batch[active], j[active]] = True
        assign[batch[active], obj[active]] = j[active]
    return _one_hot_rows(assign, valid_row, p)


def hungarian_host(cost: torch.Tensor, num_objects: torch.Tensor
                   ) -> torch.Tensor:
    """The exact matching of scipy's ``linear_sum_assignment`` on the host,
    problem by problem (matching.py:311): the oracle, not a hot path. It
    takes a tensor on any device and returns the mask on that device."""
    from scipy.optimize import linear_sum_assignment

    cost_np = cost.detach().float().cpu().numpy()
    n_np = num_objects.reshape(-1).cpu().numpy().astype(np.int64)
    masks = np.zeros_like(cost_np)
    for i in range(cost_np.shape[0]):
        ni = int(n_np[i])
        if ni > 0:
            r, c = linear_sum_assignment(cost_np[i, :ni, :])
            masks[i][r, c] = 1.0
    return torch.from_numpy(masks).to(cost.device)


def solve_matching(cost: torch.Tensor, num_objects: torch.Tensor,
                   method: str = "hungarian") -> torch.Tensor:
    """Dispatches to a matcher: ``hungarian`` is the plain exact solver on
    any device; ``pallas`` (or ``hungarian_pallas``) is the K2 kernel on
    CUDA tensors and the plain solver on CPU tensors; ``auction`` and
    ``greedy`` (unshuffled) are approximate; ``hungarian_host`` is scipy
    on the host."""
    cost = cost.detach()
    if method == "hungarian":
        return hungarian_lap(cost, num_objects)
    if method == "auction":
        return auction_lap(cost, num_objects)
    if method in ("pallas", "hungarian_pallas"):
        return lap.hungarian_lap(cost, num_objects)
    if method == "greedy":
        return greedy_lap(cost, num_objects)
    if method == "hungarian_host":
        return hungarian_host(cost, num_objects)
    raise ValueError(f"unknown matcher '{method}'")


def matching_loss(category_onehot: torch.Tensor,
                  attribute_multihot: torch.Tensor, bbox: torch.Tensor,
                  num_objects: torch.Tensor, cat_preds: torch.Tensor,
                  attribute_preds: torch.Tensor, box_preds: torch.Tensor,
                  weights: LossWeights = LossWeights(),
                  matcher: str = "hungarian",
                  return_assignment: bool = False):
    """The bipartite-matched DETR set loss.

    Targets: ``category_onehot`` [B, O, Vc], ``attribute_multihot``
    [B, O, Va], ``bbox`` [B, O, 4] COCO, ``num_objects`` [B]. Predictions:
    ``cat_preds`` [B, P, Vc] softmax, ``attribute_preds`` [B, P, Va]
    sigmoid, ``box_preds`` [B, P, 4] COCO. Returns ``(losses, metrics)``,
    or ``(losses, metrics, mask)`` with ``return_assignment``: [B] vectors
    ``total``/``category``/``attribute``/``box``/``exist`` and ``iou``.

    Normalisation is batch-global: the matched sums are divided by
    ``1 + sum(num_objects)`` over the whole batch (the global batch under
    data parallelism, ``mesh.data_sum``); the exist term is meaned over
    the predictions and divided by ``1 + P``."""
    cat_preds = cat_preds.float()
    attribute_preds = attribute_preds.float()
    box_preds = box_preds.float()
    num_objects = num_objects.reshape(-1)
    p_count = cat_preds.shape[1]

    category_cost = weights.category * loss_ops.category_cost(
        category_onehot, cat_preds)
    attribute_cost = weights.attribute * loss_ops.attribute_cost(
        attribute_multihot, attribute_preds)
    box_cost = weights.box * loss_ops.pairwise(
        functools.partial(loss_ops.box_loss, giou_weight=weights.giou,
                          l2_weight=weights.l2), bbox, box_preds)
    total_cost = category_cost + box_cost + attribute_cost
    mask = solve_matching(total_cost, num_objects, matcher)
    assigned = mask.amax(dim=-2)  # [B, P]: predictions that won an object

    total_num_objects = 1.0 + mesh_lib.data_sum(num_objects)
    num_preds_per_batch = 1.0 + float(p_count)

    def reduce(cost):
        return (mask * cost).sum(dim=(-2, -1)) / total_num_objects

    category_term = reduce(category_cost)
    attribute_term = reduce(attribute_cost)
    box_term = reduce(box_cost)
    exist = weights.exist * loss_ops.exist_loss(
        (1.0 - assigned)[..., None], cat_preds[..., 0:1])
    exist_term = exist.mean(-1) / num_preds_per_batch

    losses = {"total": category_term + attribute_term + box_term + exist_term,
              "category": category_term, "attribute": attribute_term,
              "box": box_term, "exist": exist_term}
    iou = loss_ops.iou_metric_pairwise(bbox, box_preds)
    metrics = {"iou": (mask * iou).sum(dim=(-2, -1)) / total_num_objects}
    if return_assignment:
        return losses, metrics, mask
    return losses, metrics
