"""Loss primitives and pairwise cost arrays in PyTorch, float32.

Counterpart of boosted_detr_tpu/ops/losses.py:30-187. ``y`` is a target and
``p`` a predicted probability (not a logit). Keras' BinaryCrossentropy clips
probabilities to [1e-7, 1 - 1e-7] and means over the last axis; both are
reproduced, so loss magnitudes match the JAX package's. The ``*_cost``
forms compute the pairwise [B, O, P] arrays as float32 einsums, without a
[B, O, P, V] intermediate.
"""

from __future__ import annotations

import torch

from boosted_detr_torch.ops import boxes as box_ops

_KERAS_EPS = 1e-7
FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0


def safe_clip(p: torch.Tensor) -> torch.Tensor:
    """Clip probabilities to [0.001, 0.999]."""
    return p.clamp(0.001, 0.999)


def _keras_clip(p: torch.Tensor) -> torch.Tensor:
    return p.clamp(_KERAS_EPS, 1.0 - _KERAS_EPS)


def bce_elementwise(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    p = _keras_clip(p.float())
    y = y.float()
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def binary_crossentropy(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Keras BinaryCrossentropy(reduction=NONE): mean over the last axis."""
    return bce_elementwise(y, p).mean(-1)


def exist_loss(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """BCE on the <PAD> ("no object") class probability."""
    return binary_crossentropy(y, safe_clip(p))


def category_loss(y_onehot: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """BCE(y, safe_clip(p) * y), meaned over the classes."""
    y = y_onehot.float()
    return binary_crossentropy(y, safe_clip(p) * y)


def sigmoid_focal_elementwise(y: torch.Tensor, p: torch.Tensor,
                              alpha: float = FOCAL_ALPHA,
                              gamma: float = FOCAL_GAMMA) -> torch.Tensor:
    """Sigmoid focal cross-entropy on probabilities (tensorflow_addons)."""
    y, p = y.float(), p.float()
    ce = bce_elementwise(y, p)
    p_t = y * p + (1.0 - y) * (1.0 - p)
    alpha_factor = y * alpha + (1.0 - y) * (1.0 - alpha)
    return alpha_factor * torch.pow(1.0 - p_t, gamma) * ce


def attribute_loss(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return sigmoid_focal_elementwise(y, safe_clip(p)).mean(-1)


def box_loss(y_coco: torch.Tensor, p_coco: torch.Tensor,
             giou_weight: float = 2.0, l2_weight: float = 5.0
             ) -> torch.Tensor:
    """``giou_weight`` * GIoU loss + ``l2_weight`` * MSE of 10x the corner
    coordinates."""
    y = box_ops.coco_to_corners(y_coco.float())
    p = box_ops.coco_to_corners(p_coco.float())
    l2 = torch.square(10.0 * y - 10.0 * p).mean(-1)
    return giou_weight * box_ops.giou_loss(y, p) + l2_weight * l2


def pairwise(fn, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """``fn`` over [B, O, 1, ...] x [B, 1, P, ...] -> [B, O, P]."""
    return fn(y_true.unsqueeze(-2), y_pred.unsqueeze(-3))


def category_cost(y_onehot: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Pairwise ``category_loss``: [B, O, Vc] x [B, P, Vc] -> [B, O, P]. For
    a one-hot row it is ``(-log(p_c) - (V - 1) log(1 - eps)) / V`` with
    ``c`` the true class, so the array is a gather of ``-log p``, written
    as an einsum against the one-hot targets."""
    y = y_onehot.float()
    v = y.shape[-1]
    neglog_p = -torch.log(_keras_clip(safe_clip(p.float())))
    off_const = -torch.log(torch.tensor(1.0 - _KERAS_EPS,
                                        dtype=torch.float32)).item()
    gathered = torch.einsum("bov,bpv->bop", y, neglog_p)
    return (gathered + (v - 1.0) * off_const) / v


def attribute_cost(y_multihot: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Pairwise ``attribute_loss``: [B, O, Va] x [B, P, Va] -> [B, O, P].
    The focal loss of a binary ``y`` is ``y f1(p) + (1 - y) f0(p)``, so its
    mean is ``(y . (f1 - f0) + sum f0) / Va``: one einsum."""
    y = y_multihot.float()
    pc = safe_clip(p.float())
    f1 = sigmoid_focal_elementwise(torch.ones_like(pc), pc)
    f0 = sigmoid_focal_elementwise(torch.zeros_like(pc), pc)
    va = y.shape[-1]
    dot = torch.einsum("bov,bpv->bop", y, f1 - f0)
    return (dot + f0.sum(-1)[:, None, :]) / va


def iou_metric_pairwise(y_coco: torch.Tensor, p_coco: torch.Tensor
                        ) -> torch.Tensor:
    """Pairwise IoU of COCO boxes [B, O, 4] x [B, P, 4] -> [B, O, P]."""
    y = box_ops.coco_to_corners(y_coco.float())
    p = box_ops.coco_to_corners(p_coco.float())
    return box_ops.iou_corners(y[..., :, None, :], p[..., None, :, :])
