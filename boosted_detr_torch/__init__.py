"""Boosted DETR in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``boosted_detr_tpu`` (JAX, Flax, Pallas), which stays as the
reference. This package imports torch and never JAX or the JAX package.
It serves and trains ``DETR`` and the boosted ensemble ``BoostedDETR``
(per-block encoders, decoder blocks and heads, with staged training:
``TrainConfig.train_block`` and ``make_optimizer(trainable_mask=
boosted_block_mask(model, k))``; early-exit serving through ``predict``
and models/early_exit.py) with the ResNet ``patchify8`` backbone (the
640px flagship, and at 1280px) or the ViT backbone, whose stem or patch
embed runs through the CUDA kernels in ``csrc/patchify.cu`` (forward and
weight gradient), whose attention runs through the fused kernels of
``csrc/attention.cu`` (forward, dq, dk/dv) with ``use_pallas_attention``,
trained by ``make_train_step`` with the exact matcher of ``csrc/lap.cu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from boosted_detr_torch.bridge import load_flax_variables, to_flax_layout
from boosted_detr_torch.config import LossWeights, ModelConfig, TrainConfig
from boosted_detr_torch.models.boosted import BoostedDETR
from boosted_detr_torch.models.detr import DETR
from boosted_detr_torch.train.steps import (TrainState, apply_trainable_mask,
                                            boosted_block_mask,
                                            make_optimizer, make_train_step,
                                            predict, with_ema_params)

__all__ = ["BoostedDETR", "DETR", "LossWeights", "ModelConfig", "TrainConfig",
           "TrainState", "apply_trainable_mask", "boosted_block_mask",
           "load_flax_variables", "make_optimizer", "make_train_step",
           "predict", "to_flax_layout", "with_ema_params"]
