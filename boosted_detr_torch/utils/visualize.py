"""Visualization helpers: box overlays for samples and predictions.

The port's copy of boosted_detr_tpu/utils/visualize.py: ``draw_boxes``,
``show_example`` and ``show_prediction`` draw COCO-normalized boxes with
category (and attribute) captions on matplotlib axes, leaving out '<PAD>'
no-object predictions. matplotlib is imported inside each function.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from boosted_detr_torch.config import PAD_TOKEN


def draw_boxes(ax, image: np.ndarray, boxes: np.ndarray,
               labels: Optional[Sequence[str]] = None,
               captions: Optional[Sequence[str]] = None,
               color: str = "lime") -> None:
    """Draw COCO-normalized [x, y, w, h] boxes on a matplotlib axis."""
    import matplotlib.patches as patches

    h, w = image.shape[:2]
    ax.imshow(np.clip(image, 0, 1))
    ax.axis("off")
    for i, box in enumerate(np.asarray(boxes)):
        x, y, bw, bh = box
        rect = patches.Rectangle((x * w, y * h), bw * w, bh * h,
                                 linewidth=1.5, edgecolor=color,
                                 facecolor="none")
        ax.add_patch(rect)
        text = ""
        if labels is not None:
            text = str(labels[i])
        if captions is not None and captions[i]:
            text = f"{text}: {captions[i]}" if text else str(captions[i])
        if text:
            ax.text(x * w, max(y * h - 2, 0), text, fontsize=7,
                    color="black", bbox=dict(facecolor=color, alpha=0.7,
                                             pad=1, edgecolor="none"))


def show_example(image: np.ndarray, batch: dict, index: int, codec,
                 ax=None, save_path: Optional[str] = None):
    """Ground-truth overlay for one batch element of a numpy batch."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    n = int(batch["num_objects"][index])
    boxes = np.asarray(batch["bbox"][index][:n])
    labels = [codec.category_vocab[int(c)]
              for c in np.asarray(batch["category_ids"][index][:n])]
    draw_boxes(ax, np.asarray(image), boxes, labels, color="deepskyblue")
    if save_path:
        ax.figure.savefig(save_path, bbox_inches="tight", dpi=120)
    return ax


def show_prediction(image: np.ndarray, categories: Sequence[str],
                    attributes: Sequence[str], boxes: np.ndarray,
                    ax=None, save_path: Optional[str] = None):
    """Prediction overlay, leaving out the '<PAD>' no-object slots."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    keep = [i for i, c in enumerate(categories) if c != PAD_TOKEN]
    draw_boxes(ax, np.asarray(image), np.asarray(boxes)[keep],
               [categories[i] for i in keep],
               [attributes[i] for i in keep])
    if save_path:
        ax.figure.savefig(save_path, bbox_inches="tight", dpi=120)
    return ax
