"""The standard DETR model in PyTorch.

Counterpart of boosted_detr_tpu/models/detr.py:31-104: backbone -> neck ->
encoder blocks -> decoder blocks -> category, attribute and box heads. The
forward maps NHWC float32 images in [0, 1] to probabilities: ``category``
[B, P, Vc] softmax, ``attribute`` [B, P, Va] sigmoid and ``boxes``
[B, P, 4], all float32.

``model.eval()`` gives the JAX ``train=False`` forward: BatchNorm uses the
running statistics and there is no dropout. ``model.train()`` gives the
``train=True`` forward: BatchNorm normalises with the batch statistics and
updates its running ones, and dropout (and the B4 backbone's stochastic
depth) draws its bits from the ``generator`` the caller passes (the train
step makes one per step).

``use_pallas_attention`` sends every attention of the model (encoder,
decoder self- and cross-attention, ViT blocks) through the fused K3
kernels (ops/attention.py), as the JAX package sends it through its Pallas
kernel (detr.py:43-65); ``use_pallas_stem`` sends the patchify stem or the
ViT patch embed through the K1 kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from boosted_detr_torch.config import ModelConfig
from boosted_detr_torch.models import layers
from boosted_detr_torch.models.backbone import BackboneNeck, EncoderBackbone
from boosted_detr_torch.models.heads import (BoxPredictionHead,
                                             MultiClassPredictionHead,
                                             SingleClassPredictionHead)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _resolve_device(device) -> torch.device:
    """``cuda`` when no device is given; without a GPU that raises rather
    than run on the CPU, which the caller asks for with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but CUDA is not available")
    return device


class DETR(nn.Module):
    """DETR on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``), with parameters drawn from ``seed`` through a
    ``torch.Generator`` in the Flax initialisers' distributions. Trained
    weights come from ``bridge.load_flax_variables``.

    ``heads=False`` builds the trunk alone (backbone, neck, encoder,
    decoder prep and blocks), as the classifier pre-trainer's ``detr``
    subtree holds it: Flax creates the heads' leaves only when they are
    called, and the pre-trainer never calls them."""

    def __init__(self, config: ModelConfig, *, device=None, seed: int = 0,
                 heads: bool = True):
        super().__init__()
        device = _resolve_device(device)
        self.config = cfg = config
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        dtype = _DTYPES[cfg.compute_dtype]
        eps = cfg.layernorm_epsilon
        pallas = cfg.use_pallas_attention
        self.backbone = EncoderBackbone(cfg.backbone, cfg.backbone_width,
                                        cfg.norm, dtype, cfg.stem,
                                        cfg.preprocessing,
                                        cfg.use_pallas_stem,
                                        use_pallas=pallas,
                                        image_size=cfg.image_size)
        self.neck = BackboneNeck(self.backbone.out_channels,
                                 cfg.encoder_dim, cfg.norm, dtype)
        self.encoder = layers.ImageEncoder(
            cfg.grid_size, cfg.encoder_dim, cfg.num_encoder_blocks,
            cfg.num_encoder_heads, eps, dtype, cfg.dropout_rate, pallas,
            cfg.post_softmax_mask)
        self.decoder_prep = layers.DecoderPrep(cfg.num_object_preds,
                                               cfg.decoder_dim, dtype)
        self.num_decoder_blocks = cfg.num_decoder_blocks
        for i in range(cfg.num_decoder_blocks):
            # decoder block 0 has no self-attention (layers.py:298)
            self.add_module(f"decoder_block_{i}", layers.DecoderBlock(
                cfg.decoder_dim, cfg.num_decoder_heads, eps, dtype,
                self_attention=(i > 0), encoder_dim=cfg.encoder_dim,
                dropout_rate=cfg.dropout_rate, use_pallas=pallas,
                post_softmax_mask=cfg.post_softmax_mask))
        if heads:
            hidden = cfg.resolved_head_hidden_dim
            self.category_head = SingleClassPredictionHead(
                cfg.decoder_dim, cfg.num_categories, hidden,
                cfg.num_object_preds, cfg.norm, dtype)
            self.attribute_head = MultiClassPredictionHead(
                cfg.decoder_dim, cfg.num_attributes, hidden,
                cfg.num_object_preds, cfg.norm, dtype)
            self.box_head = BoxPredictionHead(
                cfg.decoder_dim, cfg.decoder_dim, cfg.num_object_preds,
                cfg.norm, dtype)
        layers.reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.encoder.positional_encoding.device

    def encode(self, image, generator=None):
        """Backbone + neck + transformer encoder -> (tokens, positional)."""
        feats = self.neck(self.backbone(image, generator))
        return self.encoder(feats, generator)

    def apply_heads(self, decoder_features) -> Dict[str, torch.Tensor]:
        return {"category": self.category_head(decoder_features),
                "attribute": self.attribute_head(decoder_features),
                "boxes": self.box_head(decoder_features)}

    def training_generator(self, generator: Optional[torch.Generator]
                           ) -> Optional[torch.Generator]:
        """The generator a forward draws from: None in eval mode; in
        training mode ``generator``, which is required when
        ``dropout_rate > 0`` or the backbone is ``efficientnet_b4``."""
        if not self.training:
            return None
        if generator is None and (self.config.dropout_rate > 0.0
                                  or self.backbone.needs_generator):
            raise ValueError("the training forward draws its random bits "
                             "from an explicit generator; pass generator=")
        return generator

    def decode(self, image: torch.Tensor, return_intermediate: bool,
               generator: Optional[torch.Generator]):
        """The trunk: yields ``(tokens, positional, decoder features)``
        after each decoder block whose output is wanted (every block's with
        ``return_intermediate``, else the last one's)."""
        tokens, pos = self.encode(image, generator)
        enc_value, dec, enc_key, _ = self.decoder_prep(tokens, pos)
        n = self.num_decoder_blocks
        for i in range(n):
            dec = getattr(self, f"decoder_block_{i}")(enc_value, dec, enc_key,
                                                      generator)
            if return_intermediate or i == n - 1:
                yield tokens, pos, dec

    def forward(self, image: torch.Tensor, *, return_intermediate: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Union[Dict[str, torch.Tensor],
                           List[Dict[str, torch.Tensor]]]:
        """``generator`` draws the dropout and stochastic-depth bits in
        training mode, where it is required when ``dropout_rate > 0`` or
        the backbone is ``efficientnet_b4``; in eval mode it is unused."""
        generator = self.training_generator(generator)
        outputs = [self.apply_heads(dec) for _, _, dec in
                   self.decode(image, return_intermediate, generator)]
        return outputs if return_intermediate else outputs[-1]
