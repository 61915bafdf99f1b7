"""Model configuration, the port's own copy.

Counterpart of boosted_detr_tpu/config.py: ``PAD_TOKEN``/``OOV_TOKEN``
(:19-20) and ``ModelConfig`` (:47-167), with the same field names and
defaults so that one set of keyword arguments builds either package's
config. Copied, never imported: the PyTorch package does not load the JAX
package. ``TrainConfig`` comes with the training slice.

Fields the port reads with a meaning of its own:
- ``use_pallas_stem``: run the patchify stem through the hand-written CUDA
  kernel (ops/patchify.py) with the preprocessing folded into its weights;
- ``compute_dtype``: the activation dtype, with parameters kept in float32
  and cast at use, as Flax does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PAD_TOKEN = "<PAD>"
OOV_TOKEN = "<OOV>"


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
