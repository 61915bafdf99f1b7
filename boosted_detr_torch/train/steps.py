"""The serving entry point.

Counterpart of ``make_predict_step`` (boosted_detr_tpu/train/steps.py:
329-339) and of ``Trainer.predict`` (train/trainer.py:427-471) without early
exit or EMA weights: numpy images in [0, 1] go in; the host codec turns the
probabilities into ``(category_strings, attribute_strings, boxes)``. The
rest of steps.py (losses, optimizer, train and eval steps) comes with the
training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from boosted_detr_torch.data.codec import TextCodec


def make_predict_step(model: nn.Module) -> Callable:
    """Inference forward (the JAX ``train=False``): puts ``model`` in eval
    mode and returns a function from an image tensor on the model's device
    to the raw probability/box tensors."""
    model.eval()

    def predict_step(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return model(image)

    return predict_step


def predict(model: nn.Module, images: np.ndarray,
            codec: Optional[TextCodec] = None, decode_text: bool = True):
    """Images [B, H, W, 3] in [0, 1] -> (category_strings,
    attribute_strings, boxes) through ``codec``, or the raw probability dict
    of numpy arrays when ``decode_text`` is False or there is no codec."""
    device = next(model.parameters()).device
    image = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    preds = make_predict_step(model)(image)
    preds = {k: v.cpu().numpy() for k, v in preds.items()}
    if decode_text and codec is not None:
        return codec.decode_predictions(preds)
    return preds
