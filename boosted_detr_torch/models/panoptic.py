"""The panoptic model in PyTorch: DETR with a mask head.

Counterpart of boosted_detr_tpu/models/panoptic.py:40-291:
``PanopticAttention`` (per-object attention maps over the image grid),
``_DownBlock``, ``_UpBlock`` and ``PanopticNeck`` (a U-Net at the mask
resolution, emitting per-object mask logits), ``DETRPanoptic`` (a ``detr``
child with DETR's forward contract, plus ``masks`` logits [B, P, S, S] in
each prediction dict), ``masks_from_boxes``, ``dice_loss``, ``mask_loss``
and the train and eval steps, whose detection and mask losses share one
bipartite assignment. Tensors are NHWC inside the neck, as in the JAX
package; submodules carry the Flax scope names for the bridge.

Traps of the JAX module, each reproduced here:
- ``_UpBlock``'s Flax ``ConvTranspose((3, 3), strides=2, padding="SAME")``
  correlates the 2x-dilated input, padded 2 before and 1 after, with the
  kernel as it is (not flipped). In torch that is ``conv_transpose2d`` of
  the flipped kernel laid out [in, out, kh, kw] at ``padding=0``, cropped to
  [:2H, :2W] (``padding=1, output_padding=1`` shifts it). The bridge flips
  and lays out a ``deconv/kernel`` so; this module's weight is torch's.
- ``_DownBlock``'s stride-2 SAME conv pads 0 before and 1 after on an even
  side (``backbone.Conv`` pads so).
- Both blocks normalise in float32 with Flax's default eps 1e-6, not
  ``layernorm_epsilon``.
- ``PanopticAttention``'s logits are float32 from q and k in the compute
  dtype (``preferred_element_type``): q and k are upcast before the
  product, which a bf16 matmul would round. The maps are laid out with
  channel ``h * Q + q``.
- The neck resizes the maps bilinearly (``align_corners=False``, JAX's
  ``linear``); where the grid is larger than ``mask_size`` JAX
  antialiases, and so does this.
- ``mask_conv`` is float32 whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from boosted_detr_torch.config import ModelConfig
from boosted_detr_torch.models import layers
from boosted_detr_torch.models.backbone import Conv
from boosted_detr_torch.models.detr import _DTYPES, DETR, _resolve_device
from boosted_detr_torch.ops import losses as loss_ops
from boosted_detr_torch.parallel import mesh as mesh_lib

# Flax's LayerNorm default, which the panoptic blocks keep
_LN_EPS = 1e-6


class PanopticAttention(nn.Module):
    """Per-object attention maps over the image grid (panoptic.py:40-69):
    softmax over the image tokens of q (from the decoder tokens) against k
    (from the image tokens plus their positional encoding), per head.
    Output [B, R, C, heads * Q] in the compute dtype."""

    def __init__(self, num_heads: int, hidden_dim: int, query_dim: int,
                 key_dim: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = max(1, hidden_dim // num_heads)
        self.dtype = dtype
        proj = num_heads * self.head_dim
        self.query_projection = layers.Dense(query_dim, proj)
        self.key_projection = layers.Dense(key_dim, proj)

    def forward(self, image_tokens, positional_tokens, decoder_tokens,
                grid_hw):
        r, c = grid_hw
        b, t, _ = image_tokens.shape
        key_in = (image_tokens.float() + positional_tokens.float()).to(
            self.dtype)
        q = self.query_projection(decoder_tokens, self.dtype)
        k = self.key_projection(key_in, self.dtype)
        nq = q.shape[1]
        q = q.reshape(b, nq, self.num_heads, self.head_dim).transpose(1, 2)
        k = k.reshape(b, t, self.num_heads, self.head_dim).transpose(1, 2)
        # float32 logits from the compute-dtype q and k (exact in float32)
        logits = q.float() @ k.float().transpose(-1, -2)  # [B, H, Q, T]
        logits = logits / math.sqrt(self.head_dim)
        maps = torch.softmax(logits, dim=-1).permute(0, 3, 1, 2)  # [B,T,H,Q]
        return maps.reshape(b, r, c, self.num_heads * nq).to(self.dtype)


class _DownBlock(nn.Module):
    """Stride-2 SAME 3x3 conv -> float32 LayerNorm -> leaky ReLU (0.01)."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv(in_channels, features, 3, stride=2, bias=True)
        self.norm = layers.LayerNorm(features, _LN_EPS)

    def forward(self, x):
        x = self.norm(self.conv(x, self.dtype)).to(self.dtype)
        return F.leaky_relu(x, 0.01)


class _UpBlock(nn.Module):
    """Flax's stride-2 SAME 3x3 ``ConvTranspose`` (H -> 2H) -> float32
    LayerNorm -> leaky ReLU (0.01). ``deconv.weight`` is torch's
    ``conv_transpose2d`` layout [in, out, kh, kw], the Flax kernel flipped
    (see the module docstring)."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.deconv = _ConvTranspose(in_channels, features)
        self.norm = layers.LayerNorm(features, _LN_EPS)

    def forward(self, x):
        x = self.norm(self.deconv(x, self.dtype)).to(self.dtype)
        return F.leaky_relu(x, 0.01)


class _ConvTranspose(nn.Module):
    """The weight [in, out, 3, 3] and bias of ``_UpBlock``'s deconv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, 3,
                                               3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        i, o, kh, kw = self.weight.shape
        # Flax's lecun_normal on its [kh, kw, in, out] kernel
        layers.variance_scaling_(self.weight, 1.0, "fan_in", i * kh * kw,
                                 o * kh * kw, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2),
                               self.weight.to(dtype), self.bias.to(dtype),
                               stride=2)
        return y[:, :, :2 * h, :2 * w].permute(0, 2, 3, 1)


class PanopticNeck(nn.Module):
    """U-Net over the per-object attention maps (panoptic.py:98-129):
    input [B, R, C, channels], output mask logits [B, num_preds, S, S]
    (float32), S = ``mask_size``."""

    def __init__(self, in_channels: int, num_preds: int, width: int = 64,
                 mask_size: int = 96, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_size = mask_size
        self.dtype = dtype
        w = width
        self.down0 = _DownBlock(in_channels, w, dtype)      # S/2
        self.down1 = _DownBlock(w, w * 2, dtype)            # S/4
        self.down2 = _DownBlock(w * 2, w * 4, dtype)        # S/8
        self.up2 = _UpBlock(w * 4, w * 2, dtype)            # S/4
        self.up1 = _UpBlock(w * 4, w, dtype)                # S/2
        self.up0 = _UpBlock(w * 2, w, dtype)                # S
        self.mask_conv = Conv(w, num_preds, 3, bias=True)

    def forward(self, maps):
        s = self.mask_size
        r, c = maps.shape[1:3]
        x = F.interpolate(maps.float().permute(0, 3, 1, 2), size=(s, s),
                          mode="bilinear", align_corners=False,
                          antialias=r > s or c > s)
        x = x.permute(0, 2, 3, 1).to(self.dtype)
        d0 = self.down0(x)
        d1 = self.down1(d0)
        d2 = self.down2(d1)
        u2 = torch.cat([self.up2(d2), d1], dim=-1)
        u1 = torch.cat([self.up1(u2), d0], dim=-1)
        u0 = self.up0(u1)
        logits = self.mask_conv(u0.float(), torch.float32)  # [B, S, S, P]
        return logits.permute(0, 3, 1, 2)


class DETRPanoptic(nn.Module):
    """DETR plus the panoptic mask head (panoptic.py:132-171), on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``), parameters drawn from ``seed``. The ``detr`` child
    is a port ``DETR``, so a detector's weights move in and out by a
    state-dict copy. The forward has DETR's contract, with ``masks``
    logits [B, P, mask_size, mask_size] (float32) in each prediction
    dict."""

    def __init__(self, config: ModelConfig, mask_size: int = 96, *,
                 device=None, seed: int = 0):
        super().__init__()
        device = _resolve_device(device)
        self.config = cfg = config
        self.mask_size = mask_size
        self.detr = DETR(cfg, device="cpu", seed=seed)
        dtype = _DTYPES[cfg.compute_dtype]
        self.panoptic_attention = PanopticAttention(
            cfg.num_panoptic_heads, cfg.panoptic_dim, cfg.decoder_dim,
            cfg.encoder_dim, dtype)
        self.panoptic_neck = PanopticNeck(
            cfg.num_panoptic_heads * cfg.num_object_preds,
            cfg.num_object_preds, width=max(32, cfg.panoptic_dim),
            mask_size=mask_size, dtype=dtype)
        generator = torch.Generator().manual_seed(seed + 1)
        layers.reset_parameters(self.panoptic_attention, generator)
        layers.reset_parameters(self.panoptic_neck, generator)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.detr.device

    def forward(self, image: torch.Tensor, *, return_intermediate: bool = False,
                generator: Optional[torch.Generator] = None):
        """As ``DETR.forward``, each prediction dict with ``masks``."""
        generator = self.detr.training_generator(generator)
        grid = self.config.grid_size
        outputs: List[Dict[str, torch.Tensor]] = []
        for tokens, pos, dec in self.detr.decode(image, return_intermediate,
                                                 generator):
            preds = self.detr.apply_heads(dec)
            maps = self.panoptic_attention(tokens, pos, dec, grid)
            preds["masks"] = self.panoptic_neck(maps)
            outputs.append(preds)
        return outputs if return_intermediate else outputs[-1]


def masks_from_boxes(bbox: torch.Tensor, num_objects: torch.Tensor,
                     mask_size: int) -> torch.Tensor:
    """Rectangular target masks from COCO boxes [B, O, 4] -> [B, O, S, S]
    float32, 1 at the pixel centres inside a box, zero on padded objects
    (panoptic.py:237-255)."""
    s = mask_size
    centers = (torch.arange(s, dtype=torch.float32, device=bbox.device)
               + 0.5) / s
    x0 = bbox[..., 0][..., None, None]
    y0 = bbox[..., 1][..., None, None]
    x1 = x0 + bbox[..., 2][..., None, None]
    y1 = y0 + bbox[..., 3][..., None, None]
    ys = centers[None, None, :, None]
    xs = centers[None, None, None, :]
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    o = bbox.shape[1]
    valid = (torch.arange(o, device=bbox.device)[None, :, None, None]
             < num_objects.reshape(-1)[:, None, None, None])
    return (inside & valid).float()


def dice_loss(mask_logits: torch.Tensor, targets: torch.Tensor,
              eps: float = 1.0) -> torch.Tensor:
    """Soft DICE loss over the trailing spatial dims: [..., H, W] -> [...]
    (panoptic.py:258-265)."""
    probs = torch.sigmoid(mask_logits.float())
    t = targets.float()
    num = 2.0 * (probs * t).sum(dim=(-2, -1)) + eps
    den = probs.sum(dim=(-2, -1)) + t.sum(dim=(-2, -1)) + eps
    return 1.0 - num / den


def mask_loss(mask_logits: torch.Tensor, target_masks: torch.Tensor,
              assignment_mask: torch.Tensor, num_objects: torch.Tensor,
              dice_weight: float = 1.0, focal_weight: float = 1.0
              ) -> torch.Tensor:
    """The matched mask loss [B] (panoptic.py:268-291): for each assigned
    (object, prediction) pair, DICE plus the sigmoid focal loss (meaned
    over the pixels) between the prediction's mask logits [B, P, H, W] and
    the object's target [B, O, H, W], divided by ``1 + sum(num_objects)``
    over the batch (the global batch under data parallelism)."""
    matched = torch.einsum("bop,bphw->bohw", assignment_mask.float(),
                           mask_logits.float())
    row_has = assignment_mask.amax(dim=-1)  # [B, O]
    d = dice_loss(matched, target_masks) * row_has
    focal = loss_ops.sigmoid_focal_elementwise(
        target_masks.float(), torch.sigmoid(matched)).mean(
            dim=(-2, -1)) * row_has
    total_num = 1.0 + mesh_lib.data_sum(num_objects)
    return (dice_weight * d.sum(-1) + focal_weight * focal.sum(-1)) \
        / total_num


def panoptic_losses(model: DETRPanoptic, train_cfg, preds, batch,
                    dice_weight: float, focal_weight: float):
    """Detection and mask losses sharing one bipartite assignment
    (panoptic.py:174-197): (the scalar loss summed over the batch, aux:
    ``loss_*`` sums, ``loss_mask`` and the mean matched IoU)."""
    from boosted_detr_torch.ops import matching
    from boosted_detr_torch.train import steps as steps_lib

    cfg = model.config
    weights = steps_lib.resolve_loss_weights(cfg, train_cfg)
    category, attribute = steps_lib.targets_from_batch(
        batch, cfg.num_categories, cfg.num_attributes)
    losses, metrics, assignment = matching.matching_loss(
        category, attribute, batch["bbox"].float(), batch["num_objects"],
        preds["category"], preds["attribute"], preds["boxes"],
        weights=weights, matcher=cfg.matcher, return_assignment=True)
    m_loss = mask_loss(preds["masks"], batch["masks"], assignment,
                       batch["num_objects"], dice_weight, focal_weight)
    total = losses["total"].sum() + m_loss.sum()
    aux = {f"loss_{k}": v.sum() for k, v in losses.items()}
    aux["loss_mask"] = m_loss.sum()
    aux["iou"] = metrics["iou"].mean()
    return total, aux


def make_panoptic_train_step(model: DETRPanoptic, train_cfg,
                             dice_weight: float = 1.0,
                             focal_weight: float = 1.0):
    """The train step of a ``DETRPanoptic`` (panoptic.py:200-220): the
    training forward (live BatchNorm, dropout from the step's generator),
    the matched detection loss plus the matched mask loss on one
    assignment, then ``make_update_step``'s backward, optimizer and EMA.
    The batch carries ``masks`` [B, O, S, S] besides the detection targets.
    ``train_step(state, batch, generator=None) -> (state, aux)``."""
    from boosted_detr_torch.train import steps as steps_lib

    def loss_fn(model, batch, generator):
        with record_function("train_step/forward"):
            steps_lib.set_mode(model, True)
            preds = model(batch["image"], generator=generator)
        with record_function("train_step/loss_and_matching"):
            return panoptic_losses(model, train_cfg, preds, batch,
                                   dice_weight, focal_weight)

    mesh = mesh_lib.make_mesh(train_cfg.mesh_shape, device=model.device)
    return steps_lib.seeded_step(model, train_cfg.seed,
                                 steps_lib.make_update_step(
                                     loss_fn, ema_decay=train_cfg.ema_decay,
                                     mesh=mesh))


def make_panoptic_eval_step(model: DETRPanoptic, train_cfg,
                            dice_weight: float = 1.0,
                            focal_weight: float = 1.0):
    """Validation (panoptic.py:223-234): the panoptic loss at ``train=False``
    with no update; returns the aux dict with ``loss`` (the global batch's
    across processes)."""
    from boosted_detr_torch.train import steps as steps_lib

    mesh = mesh_lib.make_mesh(train_cfg.mesh_shape, device=model.device)

    def eval_step(state, batch) -> Dict[str, torch.Tensor]:
        steps_lib.check_state(state, model)
        steps_lib.set_mode(model, False)
        with torch.no_grad(), mesh:
            preds = state.model(batch["image"])
            total, aux = panoptic_losses(model, train_cfg, preds, batch,
                                         dice_weight, focal_weight)
            aux["loss"] = total
            return mesh_lib.global_metrics(aux, mesh)

    return eval_step
