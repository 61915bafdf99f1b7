"""Prediction heads in PyTorch.

Counterpart of boosted_detr_tpu/models/heads.py:19-101 (``_TokenResize``,
``BoxPredictionHead``, ``SingleClassPredictionHead``,
``MultiClassPredictionHead``). Each head: optional token-count resize, then
Dense(hidden, he_normal) -> relu -> BatchNorm -> Dense(out) in float32 ->
activation. BatchNorm normalises the [B, T, C] tokens per channel over B
and T (heads.py:51). Outputs are float32.
"""

from __future__ import annotations

import torch
from torch import nn

from boosted_detr_torch.models.backbone import make_norm
from boosted_detr_torch.models.layers import Dense


class _TokenResize(nn.Module):
    """Dense along the token axis: [B, T, D] -> [B, num_preds, D]; the
    identity (and no parameters) when T == num_preds, which is the DETR
    case. The Flax module is unnamed, so its scope is ``_TokenResize_0``."""

    def __init__(self, num_tokens: int, num_preds: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.resize = (Dense(num_tokens, num_preds)
                       if num_tokens != num_preds else None)

    def forward(self, x):
        if self.resize is None:
            return x
        return self.resize(x.transpose(1, 2), self.dtype).transpose(1, 2)


class _Head(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 out_name: str, num_tokens: int, num_preds: int, norm: str,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.out_name = out_name
        self._TokenResize_0 = _TokenResize(num_tokens, num_preds, dtype)
        self.dense = Dense(in_dim, hidden_dim, "he_normal")
        self.norm = make_norm(norm, hidden_dim, dtype)
        self.add_module(out_name, Dense(hidden_dim, out_dim, "glorot_normal"))

    def pre_activation(self, features):
        x = self._TokenResize_0(features)
        x = torch.relu(self.dense(x, self.dtype))
        x = self.norm(x)
        return getattr(self, self.out_name)(x.float(), torch.float32)


class BoxPredictionHead(_Head):
    """Boxes via the expanded sigmoid ``3*sigmoid(x/100) - 1``, COCO [x,y,w,h]."""

    def __init__(self, in_dim, hidden_dim, num_preds, norm="batchnorm",
                 dtype=torch.float32, num_tokens=None):
        super().__init__(in_dim, hidden_dim, 4, "box_coords",
                         num_tokens or num_preds, num_preds, norm, dtype)

    def forward(self, features):
        return 3.0 * torch.sigmoid(self.pre_activation(features) / 100.0) - 1.0


class SingleClassPredictionHead(_Head):
    """Softmax category probabilities; class 0 (<PAD>) is 'no object'."""

    def __init__(self, in_dim, num_classes, hidden_dim, num_preds,
                 norm="batchnorm", dtype=torch.float32, num_tokens=None):
        super().__init__(in_dim, hidden_dim, num_classes, "logits",
                         num_tokens or num_preds, num_preds, norm, dtype)

    def forward(self, features):
        return torch.softmax(self.pre_activation(features), dim=-1)


class MultiClassPredictionHead(_Head):
    """Independent sigmoid probabilities per class (multi-label)."""

    def __init__(self, in_dim, num_classes, hidden_dim, num_preds,
                 norm="batchnorm", dtype=torch.float32, num_tokens=None):
        super().__init__(in_dim, hidden_dim, num_classes, "logits",
                         num_tokens or num_preds, num_preds, norm, dtype)

    def forward(self, features):
        return torch.sigmoid(self.pre_activation(features))
