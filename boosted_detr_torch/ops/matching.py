"""Bipartite matching and the DETR matching loss in PyTorch.

Counterpart of boosted_detr_tpu/ops/matching.py: ``hungarian_lap``
(:145-163), ``solve_matching`` (:348-365) and ``matching_loss``
(:373-456). The solver runs on the device that holds the cost: the exact
solver of ops/lap.py, whose plain version serves ``"hungarian"`` and whose
CUDA kernel serves ``"pallas"``. Only the first ``num_objects[b]`` rows of
problem b take part; the mask is [B, max_objects, num_preds], float32, and
carries no gradient. Ties may resolve otherwise than another exact solver
would; any optimal assignment gives the same loss.
"""

from __future__ import annotations

import functools

import torch

from boosted_detr_torch.config import LossWeights
from boosted_detr_torch.ops import lap
from boosted_detr_torch.ops import losses as loss_ops

# The exact solver of any device; on a CUDA tensor ``matcher="pallas"``
# takes the kernel through ``lap.hungarian_lap`` instead.
hungarian_lap = lap.hungarian_lap_reference

_LATER = ("matcher '{}' is not ported yet (ROADMAP.md, Queue 1: the port "
          "has the exact solvers 'hungarian' and 'pallas')")


def solve_matching(cost: torch.Tensor, num_objects: torch.Tensor,
                   method: str = "hungarian") -> torch.Tensor:
    """Dispatches to a matcher: ``hungarian`` is the plain exact solver on
    any device; ``pallas`` (or ``hungarian_pallas``) is the K2 kernel on
    CUDA tensors and the plain solver on CPU tensors."""
    cost = cost.detach()
    if method == "hungarian":
        return hungarian_lap(cost, num_objects)
    if method in ("pallas", "hungarian_pallas"):
        return lap.hungarian_lap(cost, num_objects)
    if method in ("auction", "greedy", "hungarian_host"):
        raise NotImplementedError(_LATER.format(method))
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
    ``1 + sum(num_objects)`` over the whole batch; the exist term is meaned
    over the predictions and divided by ``1 + P``."""
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

    total_num_objects = 1.0 + num_objects.sum().float()
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
