"""Model configuration, the port's own copy.

Counterpart of boosted_detr_tpu/config.py: ``PAD_TOKEN``/``OOV_TOKEN``
(:19-20), ``LossWeights`` (:22-44), ``ModelConfig`` (:47-167) and
``TrainConfig`` (:170-220), with the same field names and defaults so that
one set of keyword arguments builds either package's config. Copied, never
imported: the PyTorch package does not load the JAX package.

Fields the port reads with a meaning of its own:
- ``use_pallas_stem``: run the patchify stem through the hand-written CUDA
  kernel (ops/patchify.py) with the preprocessing folded into its weights;
- ``use_pallas_attention``: run every attention (DETR encoder and decoder,
  ViT blocks) through the hand-written CUDA K3 kernels (ops/attention.py),
  with the numerics of the JAX package's Pallas kernel;
- ``compute_dtype``: the activation dtype, with parameters kept in float32
  and cast at use, as Flax does;
- ``matcher="pallas"``: the exact matcher through the hand-written CUDA
  kernel (ops/lap.py) on CUDA tensors.

``TrainConfig.train_block`` is staged boosted training (train/steps.py:
the focused forward and loss with intermediate losses; the frozen leaves
are the optimizer's ``trainable_mask``); ``TrainConfig.agc_clip`` is the
adaptive gradient clip of the norm-free (``skipinit``) backbone, first in
the optimizer's chain (train/steps.py). ``TrainConfig.mesh_shape``
({"data": D, "model": M}; every rank of the process group on 'data' when
None) is the mesh of a run across processes (parallel/mesh.py): the train
and eval steps compute the global batch's step, the Trainer places each
process's rows of it.

``Filepaths``, ``from_yaml`` (dotted overrides, as the CLI gives them) and
``default_params`` are the helpers of config.py:224-287.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

PAD_TOKEN = "<PAD>"
OOV_TOKEN = "<OOV>"

# Default loss weights (the reference's losses_and_metrics.py:8-11).
DEFAULT_CATEGORY_WEIGHT = 1000.0
DEFAULT_BOX_WEIGHT = 1.0
DEFAULT_ATTRIBUTE_WEIGHT = 100.0
DEFAULT_EXIST_WEIGHT = 100.0


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Matching-loss term weights; ``giou`` and ``l2`` weigh the two parts
    of the box loss."""

    category: float = DEFAULT_CATEGORY_WEIGHT
    box: float = DEFAULT_BOX_WEIGHT
    attribute: float = DEFAULT_ATTRIBUTE_WEIGHT
    exist: float = DEFAULT_EXIST_WEIGHT
    giou: float = 2.0
    l2: float = 5.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- reference-parity surface ---
    num_object_preds: int = 96
    image_size: Tuple[int, int] = (560, 560)
    num_encoder_blocks: int = 4
    num_encoder_heads: int = 8
    encoder_dim: int = 256
    num_decoder_blocks: int = 4
    num_decoder_heads: int = 8
    decoder_dim: int = 256
    num_panoptic_heads: int = 1
    panoptic_dim: int = 32
    num_categories: int = 82  # vocab size incl. <PAD> and <OOV>
    num_attributes: int = 296  # vocab size incl. <PAD> and <OOV>
    classification_only: bool = False

    # --- architecture ---
    backbone: str = "efficientnet_lite"
    backbone_width: float = 1.0
    stem: str = "conv7"  # conv7 | patchify | patchify8
    preprocessing: str = "scale"  # scale | imagenet | caffe
    head_hidden_dim: Optional[int] = None  # None = 4*decoder_dim
    dropout_rate: float = 0.1
    layernorm_epsilon: float = 1e-3

    # --- data contract ---
    max_objects: int = 32

    # --- accelerator knobs ---
    compute_dtype: str = "bfloat16"
    matcher: str = "hungarian"
    use_pallas_attention: bool = False
    use_pallas_stem: bool = False
    norm: str = "batchnorm"

    # --- boosted-architecture ablations ---
    boosted_queries: str = "fresh"
    boosted_carry_threshold: float = 0.9
    boosted_shared_encoder: bool = False

    # --- reference-quirk compatibility flags ---
    post_softmax_mask: bool = True
    block0_double_count: bool = False

    # --- early-exit inference ---
    early_exit_threshold: Optional[float] = None
    early_exit_criterion: str = "confidence"

    @property
    def resolved_head_hidden_dim(self) -> int:
        return self.head_hidden_dim or 4 * self.decoder_dim

    @property
    def grid_size(self) -> Tuple[int, int]:
        """Backbone output grid (stride-32), e.g. 560x560 -> 18x18 (ceil)."""
        return (-(-self.image_size[0] // 32), -(-self.image_size[1] // 32))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    learning_rate: float = 1e-3
    lr_schedule: str = "cosine_restarts"  # cosine_restarts | aiayn | constant
    warmup_steps: int = 4000
    momentum: float = 0.9
    nesterov: bool = True
    clipnorm: float = 0.1  # per tensor, Keras ``clipnorm``
    agc_clip: float = 0.0  # adaptive gradient clip (skipinit backbone)
    ema_decay: float = 0.0
    optimizer: str = "sgd"  # sgd | adamw
    weight_decay: float = 0.0
    loss_weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    train_block: Optional[int] = None  # staged boosted training
    freeze_bn_stats: bool = False
    use_intermediate_losses: bool = False
    intermediate_loss_avg: bool = False
    seed: int = 0
    mesh_shape: Optional[Dict[str, int]] = None  # parallel/mesh.py
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Filepaths:
    """Path conventions (config.py:224-241 of the JAX package): plain fields
    with the ``default_params()`` accessor."""

    model_name: str = "custom_DETR"
    dataset_name: str = "COCO"
    archive_base_dir: str = "/tmp/datasets/archive"
    local_base_dir: str = "/tmp/datasets/local"
    checkpoint_load_dir: str = "/tmp/checkpoints"
    checkpoint_save_dir: str = "/tmp/checkpoints"
    model_files_dir: str = ""
    tfrec_files_dir: str = "/tmp/tfrecords"

    def default_params(self, value: Optional[str] = None):
        params = dataclasses.asdict(self)
        return params[value] if value is not None else params


def from_yaml(path: str, **cli_overrides: Any) -> Tuple[ModelConfig,
                                                        TrainConfig]:
    """A YAML file with optional ``model`` and ``train`` sections, overlaid
    by ``cli_overrides`` with dotted keys such as ``model.encoder_dim=512``
    or ``train.batch_size=16`` (config.py:244-268). PyYAML is imported
    here, not with the module."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    model_kw = dict(raw.get("model", {}))
    train_kw = dict(raw.get("train", {}))
    for key, val in cli_overrides.items():
        section, _, name = key.partition(".")
        if section == "model":
            model_kw[name] = val
        elif section == "train":
            train_kw[name] = val
        else:
            raise KeyError(f"override '{key}' must start with model./train.")
    if "image_size" in model_kw:
        model_kw["image_size"] = tuple(model_kw["image_size"])
    if "loss_weights" in train_kw:
        train_kw["loss_weights"] = LossWeights(**train_kw["loss_weights"])
    return ModelConfig(**model_kw), TrainConfig(**train_kw)


def default_params(dataset_name: str = "COCO", **overrides: Any
                   ) -> ModelConfig:
    """A ``ModelConfig`` whose vocabulary sizes are ``dataset_name``'s
    (``data/vocabularies.py``) with <PAD> and <OOV>, then ``overrides``
    (config.py:276-287)."""
    from boosted_detr_torch.data import vocabularies

    vocab = vocabularies.vocab_dict(dataset_name)
    cfg = ModelConfig(
        num_categories=len(vocab["category"]) + 2,  # + PAD + OOV
        num_attributes=len(vocab["attribute"]) + 2,
    )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
