"""User-facing model API with the reference's surface, in PyTorch.

Counterpart of boosted_detr_tpu/api.py. A user of the reference builds
``model.DETR(**ModelParameters.default_params())``, calls
``compile(optimizer)`` and ``fit(ds)``, and runs inference with
``model({'image': images})`` getting ``(category_strings,
attribute_strings, boxes)`` back. These wrappers keep that surface over the
port's module, host text codec and ``Trainer``.

What differs from JAX, and why: the port's module holds its weights from
its construction (drawn from seed 0, ``TrainConfig().seed``), where the JAX
module gets them at ``compile``; ``compile``'s ``optimizer`` is a ready
``steps.Optimizer`` over this model's parameters (``make_optimizer``'s
type) where JAX's is an optax transformation; ``save`` writes the port's
weights (``Trainer.save_weights``), so a model saved by the port loads in
the port. Every constructor and ``load_model`` take ``device``: ``cuda``
unless the caller passes another (``device="cpu"`` on a machine without a
card).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from boosted_detr_torch.config import LossWeights, ModelConfig, TrainConfig
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.data.pipeline import Pipeline
from boosted_detr_torch.models.boosted import BoostedDETR as _BoostedModule
from boosted_detr_torch.models.detr import DETR as _DETRModule
from boosted_detr_torch.models.detr import _resolve_device
from boosted_detr_torch.models.panoptic import DETRPanoptic as _PanopticModule
from boosted_detr_torch.parallel.mesh import world_rank
from boosted_detr_torch.train.trainer import Trainer


class _ModelBase:
    _module_cls = None
    _is_boosted = False

    def __init__(self, num_object_preds: int = 96,
                 image_size: Tuple[int, int] = (560, 560),
                 num_encoder_blocks: int = 4, num_encoder_heads: int = 8,
                 encoder_dim: int = 256, num_decoder_blocks: int = 4,
                 num_decoder_heads: int = 8, decoder_dim: int = 256,
                 num_panoptic_heads: int = 1, panoptic_dim: int = 32,
                 vocab_dict: Optional[Dict[str, Sequence[str]]] = None,
                 classification_only: bool = False,
                 attribute_weight: float = 1.0, name: str = "DETR",
                 device=None, **overrides: Any):
        if vocab_dict is None:
            raise ValueError("vocab_dict is required")
        self.name = name
        self.device = _resolve_device(device)
        self.codec = TextCodec(vocab_dict)
        # module-level (non-ModelConfig) knobs: DETRPanoptic's mask
        # resolution rides the same constructor for API symmetry
        module_kwargs = {}
        if "mask_size" in overrides:
            module_kwargs["mask_size"] = overrides.pop("mask_size")
        sizes = self.codec.vocab_size_dict()
        self.config = ModelConfig(
            num_object_preds=num_object_preds,
            image_size=tuple(image_size),
            num_encoder_blocks=num_encoder_blocks,
            num_encoder_heads=num_encoder_heads, encoder_dim=encoder_dim,
            num_decoder_blocks=num_decoder_blocks,
            num_decoder_heads=num_decoder_heads, decoder_dim=decoder_dim,
            num_panoptic_heads=num_panoptic_heads, panoptic_dim=panoptic_dim,
            num_categories=sizes["category"],
            num_attributes=sizes["attributes"],
            classification_only=classification_only,
            **overrides)
        # loss weights stay OUT of get_config (reference model.py:37-42)
        self.loss_weights = LossWeights(attribute=100.0 * attribute_weight,
                                        box=0.0 if classification_only
                                        else LossWeights.box)
        self.module = self._module_cls(self.config, device=self.device,
                                       **module_kwargs)
        self.trainer: Optional[Trainer] = None
        self._vocab_dict = {k: list(v) for k, v in vocab_dict.items()}

    # -- reference-parity accessors --
    def get_config(self) -> Dict[str, Any]:
        """Reference model.py:129-143 (loss weights deliberately excluded)."""
        c = self.config
        return {
            "num_object_preds": c.num_object_preds,
            "image_size": c.image_size,
            "num_encoder_blocks": c.num_encoder_blocks,
            "num_encoder_heads": c.num_encoder_heads,
            "encoder_dim": c.encoder_dim,
            "num_decoder_blocks": c.num_decoder_blocks,
            "num_decoder_heads": c.num_decoder_heads,
            "decoder_dim": c.decoder_dim,
            "num_panoptic_heads": c.num_panoptic_heads,
            "panoptic_dim": c.panoptic_dim,
            "vocab_dict": self._vocab_dict,
        }

    def citation(self) -> str:
        return ("DETR-like model for object detection and fine-grained "
                "classification, after Carion et al., 'End-to-End Object "
                "Detection with Transformers' (Apache 2.0); re-implemented "
                "in PyTorch with hand-written CUDA kernels for Hopper.")

    # -- Keras-like training surface --
    def compile(self, optimizer=None,
                train_config: Optional[TrainConfig] = None,
                sample_batch: Optional[Dict[str, np.ndarray]] = None,
                batch_size: int = 8, **train_overrides: Any) -> Trainer:
        tcfg = train_config or TrainConfig()
        over = dict(train_overrides)
        # loss-weight precedence: explicit kwarg > an explicit non-default
        # train_config.loss_weights > this model's constructor-derived
        # weights (attribute_weight / classification_only)
        if "loss_weights" not in over and tcfg.loss_weights == LossWeights():
            over["loss_weights"] = self.loss_weights
        if self._is_boosted:
            over.setdefault("use_intermediate_losses", True)
        tcfg = tcfg.replace(**over)
        if sample_batch is None:
            h, w = self.config.image_size
            sample_batch = {"image": np.zeros((batch_size, h, w, 3),
                                              np.float32)}
        self.trainer = Trainer(self.module, self.config, tcfg,
                               codec=self.codec, device=self.device)
        self.trainer.compile(optimizer=optimizer, sample_batch=sample_batch)
        return self.trainer

    def make_pipeline(self, max_attribute_words: int = 8,
                      dataset=None, mask_size: Optional[int] = None
                      ) -> Pipeline:
        return Pipeline(self.config.image_size, self.config.max_objects,
                        self.codec, max_attribute_words, dataset=dataset,
                        mask_size=mask_size)

    def _require_trainer(self) -> Trainer:
        if self.trainer is None:
            raise RuntimeError("call compile() first")
        return self.trainer

    def fit(self, batches: Iterable, **kw):
        return self._require_trainer().fit(batches, **kw)

    def evaluate(self, batches: Iterable):
        return self._require_trainer().evaluate(batches)

    def load_pretrained_backbone(self, source: str):
        """Offline ImageNet-weight import for the ResNet backbone (the
        reference's ``weights='imagenet'`` option): an npz in the
        documented layout or a torchvision-style state-dict file. Set
        ``preprocessing='imagenet'|'caffe'`` in the constructor to match
        the weights. See models/pretrained.py."""
        self._require_trainer().load_pretrained_backbone(source)
        return self

    # -- whole-model persistence (config + vocab + weights) --
    def save(self, path: str):
        """Save config, vocabulary and weights to a directory (the Keras
        ``save_model`` equivalent): ``model_config.json`` with JAX's keys
        and the port's ``weights`` (the state dict, BatchNorm statistics
        and the EMA shadow included). Across processes every rank calls
        it: rank 0 writes and every rank waits for the files."""
        trainer = self._require_trainer()
        meta = {"class": type(self).__name__,
                "vocab_dict": self._vocab_dict,
                "full_config": dataclasses.asdict(self.config),
                "loss_weights": dataclasses.asdict(self.loss_weights),
                # EMA decay round-trips so load_model() rebuilds a state
                # that can receive the saved shadow weights
                "ema_decay": trainer.train_cfg.ema_decay}
        if hasattr(self.module, "mask_size"):
            # module-level knob outside ModelConfig (DETRPanoptic): a saved
            # custom mask resolution must survive load_model()
            meta["mask_size"] = self.module.mask_size
        if world_rank() == 0:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "model_config.json"), "w") as f:
                json.dump(meta, f, indent=2)
        trainer.save_weights(os.path.join(path, "weights"))

    # -- inference: text in/out (reference model.py:226-233) --
    def __call__(self, inputs, training: bool = False,
                 early_exit_threshold: Optional[float] = None):
        image = inputs["image"] if isinstance(inputs, dict) else inputs
        return self._require_trainer().predict(
            image, decode_text=not training,
            early_exit_threshold=early_exit_threshold)


class DETR(_ModelBase):
    """Standard DETR (reference model.py:12)."""

    _module_cls = _DETRModule


class BoostedDETR(_ModelBase):
    """Boosted weak-learner DETR (reference boosted_model.py:12)."""

    _module_cls = _BoostedModule
    _is_boosted = True


class DETRPanoptic(_ModelBase):
    """DETR with the panoptic mask head (models/panoptic.py). ``compile``
    builds the panoptic train step (detection and matched mask loss);
    batches must carry 'masks' [B, O, S, S] targets, which
    ``make_pipeline`` produces from COCO segmentation annotations."""

    _module_cls = _PanopticModule

    def make_pipeline(self, max_attribute_words: int = 8,
                      dataset=None, mask_size: Optional[int] = None
                      ) -> Pipeline:
        # default mask targets to the module's mask resolution; an explicit
        # mask_size=0 means "detection-only pipeline, no mask targets"
        return super().make_pipeline(
            max_attribute_words, dataset=dataset,
            mask_size=(self.module.mask_size if mask_size is None
                       else mask_size))


class DETR_MultiClassifier:
    """Classifier pre-trainer sharing a base model's trunk (reference
    model_pretrainer.py:9). Train with ``compile`` and ``fit`` here (the
    port's ``make_pretrain_step``); move the trunk into the base model with
    ``transfer_to_base``. The module lies on the base model's device."""

    def __init__(self, base_model: _ModelBase,
                 vocab_dict: Dict[str, Sequence[str]], hidden_dim: int = 256,
                 name: str = "DETR_MultiClassifier"):
        from boosted_detr_torch.models.pretrainer import DETRMultiClassifier

        self.base_model = base_model
        self.codec = TextCodec(vocab_dict)
        self.name = name
        sizes = self.codec.vocab_size_dict()
        self.module = DETRMultiClassifier(
            base_model.config, num_classifier_classes=sizes["category"],
            hidden_dim=hidden_dim, device=base_model.device)
        self.state = None
        self._step = None

    def compile(self, train_config: Optional[TrainConfig] = None,
                sample_batch: Optional[Dict[str, np.ndarray]] = None,
                batch_size: int = 8):
        """The optimizer (``make_optimizer`` over the module's parameters),
        the state and the pre-training step. ``sample_batch``, where given,
        must hold images of the base config's size."""
        from boosted_detr_torch.models import pretrainer as pt
        from boosted_detr_torch.train import steps as steps_lib

        tcfg = train_config or TrainConfig()
        want = tuple(self.base_model.config.image_size)
        if sample_batch is not None and tuple(
                np.shape(sample_batch["image"]))[1:3] != want:
            raise ValueError(f"sample images are not {want}")
        tx = steps_lib.make_optimizer(
            tcfg, self.module.named_parameters(),
            d_model=self.base_model.config.decoder_dim)
        self.state = steps_lib.TrainState.create(self.module, tx)
        self._step = pt.make_pretrain_step(self.module)
        return self

    def fit(self, batches: Iterable, epochs: int = 1):
        """``batches``: an iterable (or a callable returning one per epoch)
        of batch dicts with ``image`` and ``category_ids``. Returns each
        epoch's mean loss."""
        if self.state is None:
            raise RuntimeError("call compile() first")
        device = self.base_model.device
        history = []
        for _ in range(epochs):
            it = batches() if callable(batches) else batches
            losses = []
            for batch in it:
                placed = {k: torch.as_tensor(np.asarray(batch[k])).to(device)
                          for k in ("image", "category_ids")}
                self.state, metrics = self._step(self.state, placed)
                losses.append(float(metrics["loss"]))
            history.append(float(np.mean(losses)))
            print(f"pretrain loss={history[-1]:.4f}", flush=True)
        return history

    def transfer_to_base(self):
        """Copy the pre-trained trunk (backbone, neck, encoder, decoder
        prep and blocks) into the base model's live state (reference
        DETR_COCO.ipynb cell 32); the base model's heads stay its own."""
        from boosted_detr_torch.models import pretrainer as pt

        base_tr = self.base_model.trainer
        if base_tr is None or self.state is None:
            raise RuntimeError("compile() both models first")
        pt.transfer_to_detr(self.module, base_tr.state.model)


_CLASSES = {"DETR": DETR, "BoostedDETR": BoostedDETR,
            "DETRPanoptic": DETRPanoptic}


def load_model(path: str, device=None, **compile_kwargs):
    """Rebuild a saved model (see ``_ModelBase.save``): reconstructs the
    class from its full config, vocabulary and loss weights on ``device``
    (``cuda`` unless given), compiles, and restores the weights."""
    with open(os.path.join(path, "model_config.json")) as f:
        meta = json.load(f)
    if meta["class"] not in _CLASSES:
        raise ValueError(f"unsupported saved model class '{meta['class']}'"
                         f" (known: {sorted(_CLASSES)})")
    cls = _CLASSES[meta["class"]]
    full = dict(meta["full_config"])
    full["image_size"] = tuple(full["image_size"])
    # vocab-derived sizes are reconstructed by the constructor from the codec
    full.pop("num_categories", None)
    full.pop("num_attributes", None)
    if "mask_size" in meta:
        full["mask_size"] = meta["mask_size"]
    model = cls(vocab_dict=meta["vocab_dict"], device=device, **full)
    model.loss_weights = LossWeights(**meta["loss_weights"])
    if meta.get("ema_decay") and "train_config" not in compile_kwargs:
        compile_kwargs["train_config"] = TrainConfig(
            ema_decay=meta["ema_decay"])
    model.compile(**compile_kwargs)
    model.trainer.load_weights(os.path.join(path, "weights"))
    return model
