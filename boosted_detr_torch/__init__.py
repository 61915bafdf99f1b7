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
trained by ``make_train_step`` with the exact matcher of ``csrc/lap.cu``
(or the approximate ``auction`` and ``greedy`` matchers, or scipy's on the
host). ``DETRPanoptic`` adds per-object mask logits to DETR and trains
with ``make_panoptic_train_step`` (a matched mask loss on the detection
loss's assignment; mask targets from ``data/masks.py``, segments and
Panoptic Quality from ``train/metrics.py``); ``DETRMultiClassifier``
pre-trains the trunk as a multi-label classifier
(``make_pretrain_step``); ``load_pretrained_backbone`` imports a ResNet
from an npz or a torchvision state dict. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from boosted_detr_torch.bridge import load_flax_variables, to_flax_layout
from boosted_detr_torch.config import LossWeights, ModelConfig, TrainConfig
from boosted_detr_torch.models.boosted import BoostedDETR
from boosted_detr_torch.models.detr import DETR
from boosted_detr_torch.models.panoptic import (DETRPanoptic,
                                                make_panoptic_eval_step,
                                                make_panoptic_train_step)
from boosted_detr_torch.models.pretrained import load_pretrained_backbone
from boosted_detr_torch.models.pretrainer import (DETRMultiClassifier,
                                                  make_pretrain_step)
from boosted_detr_torch.train.steps import (TrainState, apply_trainable_mask,
                                            boosted_block_mask,
                                            make_optimizer, make_train_step,
                                            predict, with_ema_params)

__all__ = ["BoostedDETR", "DETR", "DETRMultiClassifier", "DETRPanoptic",
           "LossWeights", "ModelConfig", "TrainConfig", "TrainState",
           "apply_trainable_mask", "boosted_block_mask",
           "load_flax_variables", "load_pretrained_backbone",
           "make_optimizer", "make_panoptic_eval_step",
           "make_panoptic_train_step", "make_pretrain_step",
           "make_train_step", "predict", "to_flax_layout",
           "with_ema_params"]
