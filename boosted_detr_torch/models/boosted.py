"""The boosted DETR ensemble in PyTorch.

Counterpart of boosted_detr_tpu/models/boosted.py:57-196: one backbone and
neck, then per weak-learner block i a 1-block image encoder with its own
positional encoding (``encoder_{i}``), the shared ``decoder_prep`` re-run on
that block's tokens, ``decoder_block_{i}`` (block 0 without
self-attention) and the heads ``category_head_{i}``, ``attribute_head_{i}``
and ``box_head_{i}``, whose hidden width is ``decoder_dim`` (not DETR's
``resolved_head_hidden_dim``). The encoder of block i > 0 takes block
i-1's tokens reshaped to the grid. Each block's output is the cumulative
sum of the blocks so far.

The ablations read from ``ModelConfig``, as in JAX:
- ``block0_double_count``: block 0's outputs counted twice (:177-183);
- ``boosted_queries``: ``fresh`` (the shared zero-init queries each
  block), ``carry`` (block i-1's decoder output as block i's queries) or
  ``confidence`` (carried features; a slot whose float32 max of the
  carried category output reaches ``boosted_carry_threshold`` freezes for
  good: its features and its outputs stay those of the block where it
  froze, and each block's output is the per-block heads' output, not a
  sum) (:148-175);
- ``boosted_shared_encoder``: one ``num_encoder_blocks``-deep encoder
  (``encoder_shared``) run once feeds every block (:73-82, :141-142).

``focused_training_layer`` (a constructor argument, or for a while with
``model.focused(k)`` on the same weights) stops the forward at block k and
returns that block's output alone: the staged train step's forward
(:191-194).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Union

import torch
from torch import nn

from boosted_detr_torch.config import ModelConfig
from boosted_detr_torch.models import layers
from boosted_detr_torch.models.backbone import BackboneNeck, EncoderBackbone
from boosted_detr_torch.models.detr import _DTYPES, _resolve_device
from boosted_detr_torch.models.heads import (BoxPredictionHead,
                                             MultiClassPredictionHead,
                                             SingleClassPredictionHead)

_QUERY_MODES = ("fresh", "carry", "confidence")


class BoostedDETR(nn.Module):
    """The boosted ensemble on ``device`` (default ``cuda``; raises without
    a GPU unless ``device="cpu"``), with parameters drawn from ``seed`` as
    ``DETR``'s are. Trained weights come from ``bridge.load_flax_variables``
    under the Flax scope names."""

    def __init__(self, config: ModelConfig, *, device=None, seed: int = 0,
                 focused_training_layer: Optional[int] = None):
        super().__init__()
        device = _resolve_device(device)
        self.config = cfg = config
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        if cfg.boosted_queries not in _QUERY_MODES:
            raise ValueError(f"boosted_queries must be one of {_QUERY_MODES}")
        self.focused_training_layer = focused_training_layer
        dtype = _DTYPES[cfg.compute_dtype]
        eps = cfg.layernorm_epsilon
        pallas = cfg.use_pallas_attention
        n = cfg.num_decoder_blocks
        self.backbone = EncoderBackbone(cfg.backbone, cfg.backbone_width,
                                        cfg.norm, dtype, cfg.stem,
                                        cfg.preprocessing,
                                        cfg.use_pallas_stem,
                                        use_pallas=pallas,
                                        image_size=cfg.image_size)
        self.neck = BackboneNeck(self.backbone.out_channels,
                                 cfg.encoder_dim, cfg.norm, dtype)

        def encoder(depth):
            return layers.ImageEncoder(
                cfg.grid_size, cfg.encoder_dim, depth, cfg.num_encoder_heads,
                eps, dtype, cfg.dropout_rate, pallas, cfg.post_softmax_mask)

        if cfg.boosted_shared_encoder:
            self.encoder_shared = encoder(cfg.num_encoder_blocks)
        else:
            for i in range(n):
                self.add_module(f"encoder_{i}", encoder(1))
        self.decoder_prep = layers.DecoderPrep(cfg.num_object_preds,
                                               cfg.decoder_dim, dtype)
        hidden = cfg.decoder_dim  # boosted.py:107-123, not 4 * decoder_dim
        for i in range(n):
            self.add_module(f"decoder_block_{i}", layers.DecoderBlock(
                cfg.decoder_dim, cfg.num_decoder_heads, eps, dtype,
                self_attention=(i > 0), encoder_dim=cfg.encoder_dim,
                dropout_rate=cfg.dropout_rate, use_pallas=pallas,
                post_softmax_mask=cfg.post_softmax_mask))
            self.add_module(f"category_head_{i}", SingleClassPredictionHead(
                cfg.decoder_dim, cfg.num_categories, hidden,
                cfg.num_object_preds, cfg.norm, dtype))
            self.add_module(f"attribute_head_{i}", MultiClassPredictionHead(
                cfg.decoder_dim, cfg.num_attributes, hidden,
                cfg.num_object_preds, cfg.norm, dtype))
            self.add_module(f"box_head_{i}", BoxPredictionHead(
                cfg.decoder_dim, hidden, cfg.num_object_preds, cfg.norm,
                dtype))
        layers.reset_parameters(self, torch.Generator().manual_seed(seed))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.decoder_prep.object_queries.device

    @contextlib.contextmanager
    def focused(self, layer: Optional[int]) -> Iterator["BoostedDETR"]:
        """This model, with its forward stopped at block ``layer`` until the
        block ends: Flax's ``clone(focused_training_layer=...)`` on the same
        parameters."""
        saved = self.focused_training_layer
        self.focused_training_layer = layer
        try:
            yield self
        finally:
            self.focused_training_layer = saved

    def block(self, i: int, name: str) -> nn.Module:
        """Weak learner ``i``'s submodule ``name``: ``encoder``,
        ``decoder_block``, ``category_head``, ``attribute_head`` or
        ``box_head``."""
        return getattr(self, f"{name}_{i}")

    def apply_block_heads(self, i: int, decoder_features
                          ) -> Dict[str, torch.Tensor]:
        return {"category": self.block(i, "category_head")(decoder_features),
                "attribute": self.block(i, "attribute_head")(
                    decoder_features),
                "boxes": self.block(i, "box_head")(decoder_features)}

    def run_block(self, i: int, feats: torch.Tensor,
                  carry: Dict[str, object],
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        """Weak learner ``i`` of the forward (boosted.py:137-189) on the
        neck's ``feats`` [B, r, c, d] and what block i-1 left in ``carry``
        (empty before block 0; updated in place: the tokens, the decoder
        features, the freeze mask and the output). Returns block i's
        output: the cumulative sums (block 0 doubled with
        ``block0_double_count``) or, under ``confidence``, the per-block
        head outputs with the frozen slots' retained. The forward runs it
        block by block; the incremental early exit (early_exit.py) runs
        the same blocks and may stop after any of them."""
        cfg = self.config
        mode = cfg.boosted_queries
        if cfg.boosted_shared_encoder:
            if i == 0:  # one encoder, run once, feeds every block
                carry["encoded"] = self.encoder_shared(feats, generator)
            tokens, pos = carry["encoded"]
        else:
            b, r, c, d = feats.shape
            grid = feats if i == 0 else carry["tokens"].reshape(b, r, c, d)
            tokens, pos = self.block(i, "encoder")(grid, generator)
            carry["tokens"] = tokens
        enc_value, dec, enc_key, _ = self.decoder_prep(tokens, pos)
        if mode != "fresh" and i > 0:
            dec = carry["dec"]  # block i-1's decoder output as the queries
        dec = self.block(i, "decoder_block")(enc_value, dec, enc_key,
                                             generator)
        if mode == "confidence" and i > 0:
            # frozen slots keep their carried features
            dec = torch.where(carry["frozen"][:, :, None], carry["dec"], dec)
        carry["dec"] = dec
        heads = self.apply_block_heads(i, dec)
        if mode == "confidence":
            # frozen slots keep the outputs of the block where they froze
            if i > 0:
                m = carry["frozen"][:, :, None]
                heads = {k: torch.where(m, carry["out"][k], v)
                         for k, v in heads.items()}
            conf = heads["category"].float().amax(dim=-1)
            newly = conf >= cfg.boosted_carry_threshold
            carry["frozen"] = newly if i == 0 else carry["frozen"] | newly
        elif i == 0:
            if cfg.block0_double_count:
                heads = {k: 2 * v for k, v in heads.items()}
        else:
            heads = {k: carry["out"][k] + v for k, v in heads.items()}
        carry["out"] = heads
        return heads

    def forward(self, image: torch.Tensor, *,
                return_intermediate: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Union[Dict[str, torch.Tensor],
                           List[Dict[str, torch.Tensor]]]:
        """``generator`` draws the dropout and stochastic-depth bits in
        training mode, where it is required when ``dropout_rate > 0`` or
        the backbone is ``efficientnet_b4``; in eval mode it is unused."""
        cfg = self.config
        if not self.training:
            generator = None
        elif generator is None and (cfg.dropout_rate > 0.0
                                    or self.backbone.needs_generator):
            raise ValueError("the training forward draws its random bits "
                             "from an explicit generator; pass generator=")
        feats = self.neck(self.backbone(image, generator))
        focused = self.focused_training_layer
        carry: Dict[str, object] = {}
        outputs: List[Dict[str, torch.Tensor]] = []
        for i in range(cfg.num_decoder_blocks):
            block_out = self.run_block(i, feats, carry, generator)
            if focused is None or i == focused:
                outputs.append(block_out)
            if focused is not None and i == focused:
                break
        return outputs if return_intermediate else outputs[-1]
