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
from an npz or a torchvision state dict.

The training loop as users run it: a dataset (``SyntheticShapes`` and the
COCO-format loaders of ``data/datasets.py``), ``Pipeline.batches`` (padded
numpy batches, the native JPEG loader), ``prefetch_to_device`` (pinned
memory and a side stream), augmentation on the card (``augment_batch``) or
whole batches rendered there (``make_batch_fn``), then ``Trainer``:
``compile``, ``fit`` (NaN guard ``NaNLossError``, validation, CSV and
TensorBoard logs, checkpoints), ``evaluate`` and ``predict``;
``train/profiling.py`` traces and meters it; ``default_params`` and
``from_yaml`` build configs. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

The user's front door, as in the JAX package: ``api`` (the Keras-shaped
``api.DETR``, ``api.BoostedDETR``, ``api.DETRPanoptic`` and
``api.DETR_MultiClassifier``, text in and text out, and ``load_model``),
the command line (``python -m boosted_detr_torch.cli train|evaluate|
export``) and ``serving`` (``export_serving`` writes a ``torch.export``
artifact that keeps the forward kernels as registered ops;
``load_serving`` serves it without the model code). Names are imported at
first use.
"""

import importlib

# Each exported name and the module that defines it, imported at first use,
# so that importing the package (as a serving process does to load an
# artifact, serving.py) loads neither the models nor the trainer.
_EXPORTS = {
    "load_flax_variables": "bridge", "to_flax_layout": "bridge",
    "LossWeights": "config", "ModelConfig": "config",
    "TrainConfig": "config", "default_params": "config",
    "from_yaml": "config",
    "augment_batch": "data.augment",
    "SyntheticShapes": "data.datasets",
    "make_batch_fn": "data.device_synth",
    "Pipeline": "data.pipeline", "prefetch_to_device": "data.pipeline",
    "BoostedDETR": "models.boosted",
    "DETR": "models.detr",
    "DETRPanoptic": "models.panoptic",
    "make_panoptic_eval_step": "models.panoptic",
    "make_panoptic_train_step": "models.panoptic",
    "load_pretrained_backbone": "models.pretrained",
    "DETRMultiClassifier": "models.pretrainer",
    "make_pretrain_step": "models.pretrainer",
    "TrainState": "train.steps", "apply_trainable_mask": "train.steps",
    "boosted_block_mask": "train.steps", "make_optimizer": "train.steps",
    "make_train_step": "train.steps", "predict": "train.steps",
    "with_ema_params": "train.steps",
    "NaNLossError": "train.trainer", "Trainer": "train.trainer",
    "load_model": "api",
    "load_serving": "serving",
}
_SUBMODULES = ("api", "serving")

__all__ = sorted(list(_EXPORTS) + ["api", "serving"])


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
