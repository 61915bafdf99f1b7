"""Box geometry in PyTorch, float32.

Counterpart of boosted_detr_tpu/ops/boxes.py:22-120. Formats, on the
trailing axis of size 4, broadcasting over any leading shape:

- COCO:    ``[xmin, ymin, width, height]`` (the label data, in [0, 1])
- corners: ``[ymin, xmin, ymax, xmax]``
- VOC:     ``[xmin, ymin, xmax, ymax]``
"""

from __future__ import annotations

import torch


def coco_to_corners(box: torch.Tensor) -> torch.Tensor:
    xmin, ymin, w, h = box.unbind(-1)
    return torch.stack([ymin, xmin, ymin + h, xmin + w], dim=-1)


def corners_to_coco(box: torch.Tensor) -> torch.Tensor:
    ymin, xmin, ymax, xmax = box.unbind(-1)
    return torch.stack([xmin, ymin, xmax - xmin, ymax - ymin], dim=-1)


def coco_to_voc(box: torch.Tensor) -> torch.Tensor:
    xmin, ymin, w, h = box.unbind(-1)
    return torch.stack([xmin, ymin, xmin + w, ymin + h], dim=-1)


def voc_to_coco(box: torch.Tensor) -> torch.Tensor:
    xmin, ymin, xmax, ymax = box.unbind(-1)
    return torch.stack([xmin, ymin, xmax - xmin, ymax - ymin], dim=-1)


def divide_no_nan(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den``, and 0 where ``den == 0`` (tf.math.divide_no_nan). The
    denominator is replaced before the division, so that no inf or NaN
    reaches the gradient either."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _area(ymin, xmin, ymax, xmax):
    return (ymax - ymin).clamp_min(0.0) * (xmax - xmin).clamp_min(0.0)


def _union_and_intersection(a, b):
    a, b = a.float(), b.float()
    a_ymin, a_xmin, a_ymax, a_xmax = a.unbind(-1)
    b_ymin, b_xmin, b_ymax, b_xmax = b.unbind(-1)
    i_area = _area(torch.maximum(a_ymin, b_ymin), torch.maximum(a_xmin, b_xmin),
                   torch.minimum(a_ymax, b_ymax), torch.minimum(a_xmax, b_xmax))
    union = (_area(a_ymin, a_xmin, a_ymax, a_xmax)
             + _area(b_ymin, b_xmin, b_ymax, b_xmax) - i_area)
    enclose = _area(torch.minimum(a_ymin, b_ymin),
                    torch.minimum(a_xmin, b_xmin),
                    torch.maximum(a_ymax, b_ymax),
                    torch.maximum(a_xmax, b_xmax))
    return union, i_area, enclose


def iou_corners(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of corner boxes; degenerate boxes have zero area."""
    union, inter, _ = _union_and_intersection(a, b)
    return divide_no_nan(inter, union)


def giou_corners(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise generalized IoU, ``iou - (enclose - union) / enclose``."""
    union, inter, enclose = _union_and_intersection(a, b)
    return (divide_no_nan(inter, union)
            - divide_no_nan(enclose - union, enclose))


def giou_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 1.0 - giou_corners(a, b)


def iou_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 1.0 - iou_corners(a, b)
