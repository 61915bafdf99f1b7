"""The ResNet and ViT backbones with the patchify stem, and the neck, in
PyTorch.

Counterpart of boosted_detr_tpu/models/backbone.py: ``make_norm`` (:49-64,
BatchNorm, in eval and training mode), ``PallasPatchifyConv``
(:103-157) as ``PatchifyConv``, ``ConvNormAct`` (:160-194),
``BottleneckBlock`` (:197-226), ``ResNetBackbone`` (:229-292, the
``patchify8`` and ``patchify`` stems), ``ViTBlock`` (:490-518),
``ViTBackbone`` (:521-582), ``parse_vit_spec`` (:585-610),
``_preprocess_affine`` (:631-643), ``EncoderBackbone`` (:646-731, the
fused-stem route and the plain route, for ``resnet`` and ``vit``/``vit_*``)
and ``BackboneNeck`` (:734-754).

Activations are NHWC at every module boundary, as in the JAX package. A
convolution hands ``x.permute(0, 3, 1, 2)`` to ``F.conv2d``: that NCHW view
of an NHWC tensor is torch's channels_last layout, so no copy is made. The
``conv7`` stem, GroupNorm, ``skipinit`` and the other backbones
(EfficientNet, tiny) are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boosted_detr_torch.models.layers import (_INITS, Dense, LayerNorm,
                                              MultiheadAttention,
                                              trig_positional_init,
                                              variance_scaling_)
from boosted_detr_torch.ops import patchify
from boosted_detr_torch.ops.patchify import same_padding


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(use_running_average=not train, momentum=0.99,
    epsilon=1e-3)`` over the last axis, for NHWC maps and for [B, T, C]
    tokens alike (the heads normalise over B and T per channel,
    heads.py:51).

    Traps:
    - eps is 1e-3 (Keras' default), not torch's 1e-5;
    - in eval mode it uses the running statistics; in training mode the
      batch statistics, taken in float32 over every axis but the last with
      Flax's fast variance ``max(0, E[x^2] - E[x]^2)`` (flax 0.12
      ``_compute_stats``), with gradients through both;
    - the running update is ``ra = 0.99 ra + 0.01 stat`` with that biased
      variance, so ``F.batch_norm`` (torch's momentum convention, unbiased
      variance) is not called;
    - Flax promotes the bf16 activations against the float32 statistics,
      normalises in float32 and only then casts to the compute dtype. That
      is written out here; cuDNN's bf16 batch norm is not called.
    A module called several times in one training forward (a head under
    ``return_intermediate``) updates its running statistics each time, as
    Flax's mutable collection does."""

    momentum = 0.99

    def __init__(self, num_features: int, dtype: torch.dtype,
                 eps: float = 1e-3):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)


def make_norm(norm: str, num_features: int, dtype: torch.dtype) -> nn.Module:
    if norm == "batchnorm":
        return BatchNorm(num_features, dtype)
    raise NotImplementedError(
        f"norm '{norm}' is not ported yet (ROADMAP.md, Queue 1: the other "
        f"backbones); the port serves norm='batchnorm'")


class Conv(nn.Module):
    """Flax ``nn.Conv(padding="SAME")`` on NHWC input in the given dtype, or
    ``padding="VALID"`` with ``valid=True``. The weight is stored as
    torch's OIHW.

    Trap: XLA's SAME padding is asymmetric (``same_padding``). The input is
    padded explicitly with ``lo = total // 2`` before and the rest after,
    and the conv runs with ``padding=0``: for the stride-2 3x3 conv of
    ``BottleneckBlock`` on an even input that is 0 before and 1 after,
    where ``padding=1`` would shift every output by one pixel."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = False, valid: bool = False):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.valid = valid
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        o, i, kh, kw = self.weight.shape
        variance_scaling_(self.weight, *_INITS["lecun_normal"], i * kh * kw,
                          o * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if not self.valid:
            top, bottom = same_padding(x.shape[1], self.kernel, self.stride)
            left, right = same_padding(x.shape[2], self.kernel, self.stride)
            if top or bottom or left or right:
                x = F.pad(x, (0, 0, left, right, top, bottom))
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dtype), bias,
                     self.stride)
        return y.permute(0, 2, 3, 1)


class PatchifyConv(nn.Module):
    """The patchify stem through the hand-written kernels
    (``ops.patchify.PatchifyConvFn``: the forward kernel, and the
    weight-gradient kernel in backward), counterpart of
    ``PallasPatchifyConv``.
    Same parameter as the plain stem conv (``weight``, OIHW), so weights
    interchange between the two routes.

    ``preprocess=(a, b, perm, clip01)`` folds the per-channel input affine
    ``a * x[..., perm] + b`` into the kernel (backbone.py:145-156):
    ``conv(a*x[perm]+b, W) = conv(x, W') + bias`` with
    ``W'[..., c, :] = (W * a)[..., inv(c), :]`` and
    ``bias = einsum("ijco,c->o", W, b)``. Traps of the fold:
    - the fold runs in float32 on the float32 parameter; only the folded
      kernel is cast to the compute dtype;
    - for ``caffe`` the channel axis is inverse-permuted (``argsort(perm)``);
    - the stem reads the raw float32 image and clips it inside the kernel
      (``clip01=True``), so no preprocessed image is ever written;
    - the bias is added after the kernel, in the output dtype; with
      ``bias=True`` (the ViT patch embed) the conv's own bias comes first,
      plus the folded one (``bias + fold``)."""

    def __init__(self, in_channels: int, features: int, patch: int,
                 bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, patch, patch))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        o, i, kh, kw = self.weight.shape
        variance_scaling_(self.weight, *_INITS["lecun_normal"], i * kh * kw,
                          o * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                preprocess=None) -> torch.Tensor:
        kernel = self.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO, float32
        bias = self.bias
        clip01 = False
        if preprocess is not None:
            a, b, perm, clip01 = preprocess
            fold = torch.einsum("ijco,c->o", kernel, b)
            bias = fold if bias is None else bias + fold
            kernel = kernel * a.reshape(1, 1, -1, 1)
            if perm is not None:
                kernel = kernel[:, :, list(np.argsort(perm)), :]
        y = patchify.PatchifyConvFn.apply(x, kernel.to(dtype).contiguous(),
                                          dtype, clip01)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y


class ConvNormAct(nn.Module):
    """Conv -> BatchNorm -> activation (backbone.py:160-194). With
    ``pallas_patchify`` the conv is the stem kernel (square, stride ==
    kernel)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, norm: str = "batchnorm", act: bool = True,
                 dtype: torch.dtype = torch.float32,
                 pallas_patchify: bool = False):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.pallas_patchify = pallas_patchify
        if pallas_patchify:
            if kernel != stride:
                raise ValueError("the patchify stem needs stride == kernel")
            self.conv = PatchifyConv(in_channels, features, kernel)
        else:
            self.conv = Conv(in_channels, features, kernel, stride)
        self.norm = make_norm(norm, features, dtype)

    def forward(self, x, preprocess=None):
        if self.pallas_patchify:
            x = self.conv(x, self.dtype, preprocess)
        elif preprocess is not None:
            raise ValueError("preprocess folding needs the patchify stem")
        else:
            x = self.conv(x, self.dtype)
        x = self.norm(x)
        return torch.relu(x) if self.act else x


class BottleneckBlock(nn.Module):
    """ResNet-v1.5 bottleneck: 1x1 reduce -> 3x3 (stride) -> 1x1 expand,
    with a 1x1 projection on the residual where the shape changes."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 norm: str = "batchnorm", dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = features // 4
        self.conv1 = ConvNormAct(in_channels, mid, 1, norm=norm, dtype=dtype)
        # the stride-2 3x3 conv is where SAME's asymmetric padding matters
        self.conv2 = ConvNormAct(mid, mid, 3, stride, norm=norm, dtype=dtype)
        self.conv3 = ConvNormAct(mid, features, 1, norm=norm, act=False,
                                 dtype=dtype)
        if in_channels != features or stride != 1:
            self.proj = ConvNormAct(in_channels, features, 1, stride,
                                    norm=norm, act=False, dtype=dtype)
        else:
            self.proj = None

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.proj is None else self.proj(x)
        return torch.relu(y + residual)


class ResNetBackbone(nn.Module):
    """ResNet-50-style backbone, stride 32, with the ``patchify8`` stem
    (8x8/s8 to w(128), then stages (4, 6, 3) at strides (1, 2, 2)) or the
    ``patchify`` stem (4x4/s4 to w(64), then stages (3, 4, 6, 3)).
    ``width`` scales channel counts with a floor of 32."""

    def __init__(self, width: float = 1.0, norm: str = "batchnorm",
                 dtype: torch.dtype = torch.float32, stem: str = "conv7",
                 pallas_stem: bool = False):
        super().__init__()
        depths = (3, 4, 6, 3)
        in_channels = 3  # RGB

        def w(c):
            return max(32, int(c * width))

        if stem == "patchify8":
            self.stem = ConvNormAct(in_channels, w(128), 8, 8, norm=norm,
                                    dtype=dtype, pallas_patchify=pallas_stem)
            stages = list(enumerate(zip(depths[1:], (w(512), w(1024),
                                                     w(2048))), start=1))
            first_strided = 2
        elif stem == "patchify":
            self.stem = ConvNormAct(in_channels, w(64), 4, 4, norm=norm,
                                    dtype=dtype, pallas_patchify=pallas_stem)
            stages = list(enumerate(zip(depths, (w(256), w(512), w(1024),
                                                 w(2048)))))
            first_strided = 1
        else:
            raise NotImplementedError(
                f"stem '{stem}' is not ported yet (ROADMAP.md, Queue 1: the "
                f"conv7 stem comes with the other backbones)")
        channels = w(128) if stem == "patchify8" else w(64)
        self.block_names = []
        for stage, (depth, feats) in stages:
            for i in range(depth):
                stride = 2 if (i == 0 and stage >= first_strided) else 1
                name = f"stage{stage}_block{i}"
                self.add_module(name, BottleneckBlock(channels, feats, stride,
                                                      norm, dtype))
                self.block_names.append(name)
                channels = feats
        self.out_channels = channels

    def forward(self, x, preprocess=None):
        x = self.stem(x, preprocess)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class ViTBlock(nn.Module):
    """Pre-LN transformer block (backbone.py:490-518): LayerNorm (eps 1e-6)
    -> MHA -> residual, LayerNorm -> Dense 4x -> GELU -> Dense -> residual.
    The residual stream stays float32; the matmuls run in the compute dtype.

    Trap: Flax's ``nn.gelu`` is the tanh approximation, so this block takes
    ``F.gelu(approximate="tanh")``, not torch's default erf GELU."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 use_pallas: bool = False, qk_norm: bool = False):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(dim, 1e-6)
        self.attn = MultiheadAttention(dim, num_heads, dtype,
                                       use_pallas=use_pallas,
                                       qk_norm=qk_norm)
        self.ln2 = LayerNorm(dim, 1e-6)
        self.mlp_in = Dense(dim, 4 * dim)
        self.mlp_out = Dense(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # float32 [B, T, D]
        dt = self.dtype
        h = self.ln1(x).to(dt)
        x = x + self.attn(h, h, h).float()
        h = self.mlp_in(self.ln2(x).to(dt), dt)
        h = self.mlp_out(F.gelu(h, approximate="tanh"), dt)
        return x + h.float()


class ViTBackbone(nn.Module):
    """Pre-LN ViT as a stride-32 backbone (backbone.py:521-582): the patch
    embed (a VALID P x P stride-P conv with bias, or the patchify kernel
    with the preprocessing folded in when ``pallas_stem``), a
    trig-initialised ``positional_embedding`` added in float32, ``depth``
    blocks, ``ln_final``, and for ``patch < 32`` the ``reduce`` conv
    (r x r stride r, r = 32 / patch, to 2 * dim, with bias) back to the
    stride-32 grid. ``image_size`` fixes the token grid, which Flax reads
    from the first input."""

    def __init__(self, image_size: Tuple[int, int], dim: int = 384,
                 depth: int = 8, num_heads: int = 6, patch: int = 16,
                 dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False, qk_norm: bool = False,
                 pallas_stem: bool = False):
        super().__init__()
        if dim % num_heads or 32 % patch:
            raise ValueError(f"ViT needs heads | dim and patch | 32, got "
                             f"dim {dim}, {num_heads} heads, patch {patch}")
        self.dim = dim
        self.dtype = dtype
        self.pallas_stem = pallas_stem
        if pallas_stem:  # SAME patches, as the kernel takes them
            self.grid = tuple(-(-s // patch) for s in image_size)
            self.patch_embed = PatchifyConv(3, dim, patch, bias=True)
        else:
            self.grid = tuple(s // patch for s in image_size)
            self.patch_embed = Conv(3, dim, patch, patch, bias=True,
                                    valid=True)
        self.positional_embedding = nn.Parameter(
            torch.empty(self.grid[0] * self.grid[1], dim))
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(
                dim, num_heads, dtype, use_pallas=use_pallas,
                qk_norm=qk_norm))
        self.ln_final = LayerNorm(dim, 1e-6)
        if patch < 32:
            r = 32 // patch
            self.reduce = Conv(dim, 2 * dim, r, r, bias=True, valid=True)
            self.out_channels = 2 * dim
        else:
            self.reduce = None
            self.out_channels = dim
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.positional_embedding.copy_(torch.from_numpy(
                trig_positional_init(*self.positional_embedding.shape)))

    def forward(self, x: torch.Tensor, preprocess=None) -> torch.Tensor:
        if self.pallas_stem:
            x = self.patch_embed(x, self.dtype, preprocess)
        elif preprocess is not None:
            raise ValueError("preprocess folding needs the patchify stem")
        else:
            x = self.patch_embed(x, self.dtype)
        b, gh, gw, _ = x.shape
        if (gh, gw) != self.grid:
            raise ValueError(f"ViT built for a {self.grid} token grid, got "
                             f"{(gh, gw)}")
        x = x.reshape(b, gh * gw, self.dim).float() + self.positional_embedding
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_final(x).reshape(b, gh, gw, self.dim).to(self.dtype)
        return x if self.reduce is None else self.reduce(x, self.dtype)


def parse_vit_spec(backbone: str, width: float
                   ) -> Tuple[int, int, int, int, bool]:
    """A ``vit[_pP][_dD][_wW][_hH][_qk]`` backbone name -> (dim, depth,
    heads, patch, qk_norm) (backbone.py:585-610). Defaults: width 384,
    depth 8, 6 heads, patch 16; ``width`` scales the embedding width; the
    ``qk`` token turns on the per-head QK-norm."""
    dim, depth, heads, patch = 384, 8, 6, 16
    qk_norm = False
    for tok in backbone.split("_")[1:]:
        if tok == "qk":
            qk_norm = True
            continue
        if len(tok) < 2 or tok[0] not in "pdwh" or not tok[1:].isdigit():
            raise ValueError(f"bad vit spec token '{tok}' in '{backbone}' "
                             "(expected p<patch>/d<depth>/w<dim>/h<heads>"
                             "/qk)")
        kind, val = tok[0], int(tok[1:])
        if kind == "p":
            patch = val
        elif kind == "d":
            depth = val
        elif kind == "w":
            dim = val
        else:
            heads = val
    return int(dim * width), depth, heads, patch, qk_norm


def _preprocess_affine(mode: str):
    """The input-handling modes of ``EncoderBackbone`` as a per-channel
    affine ``a * x[..., perm] + b`` over the clipped [0,1] image."""
    if mode == "scale":
        return [2.0] * 3, [-1.0] * 3, None
    if mode == "imagenet":
        mean = np.asarray([0.485, 0.456, 0.406])
        std = np.asarray([0.229, 0.224, 0.225])
        return list(1.0 / std), list(-mean / std), None
    if mode == "caffe":
        return [255.0] * 3, [-103.939, -116.779, -123.68], [2, 1, 0]
    raise ValueError(f"unknown preprocessing '{mode}'")


class EncoderBackbone(nn.Module):
    """Input handling + backbone: images arrive in [0,1] as NHWC float32.

    Fused-stem route (``use_pallas_stem`` with a ViT, or with a ResNet
    patchify stem): the raw float32 image goes straight to the stem kernel,
    which clips it, and the preprocessing affine is folded into the stem
    weights. Plain route: clip, preprocess and cast here, then the
    ordinary stem conv. ``backbone`` is ``resnet`` (submodule ``resnet``)
    or ``vit``/``vit_*`` (submodule ``vit``, whose blocks take the fused
    attention when ``use_pallas``); the ViT needs ``image_size``.
    ``out_channels`` is the width the neck receives."""

    def __init__(self, backbone: str = "resnet", width: float = 1.0,
                 norm: str = "batchnorm", dtype: torch.dtype = torch.float32,
                 stem: str = "conv7", preprocessing: str = "scale",
                 use_pallas_stem: bool = False, *, use_pallas: bool = False,
                 image_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        # exact-prefix match, as in JAX: "vitp32" is not a ViT
        is_vit = backbone == "vit" or backbone.startswith("vit_")
        if backbone != "resnet" and not is_vit:
            raise NotImplementedError(
                f"backbone '{backbone}' is not ported yet (ROADMAP.md, "
                f"Queue 1); the port serves backbone='resnet' and 'vit'")
        self.dtype = dtype
        self.preprocessing = preprocessing
        self.fused = use_pallas_stem and (is_vit
                                          or stem.startswith("patchify"))
        a, b, perm = _preprocess_affine(preprocessing)
        self.perm = perm
        # constants, not weights: kept out of the state_dict
        self.register_buffer("pre_scale", torch.tensor(a, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("pre_shift", torch.tensor(b, dtype=torch.float32),
                             persistent=False)
        if is_vit:
            if image_size is None:
                raise ValueError("the ViT backbone needs image_size")
            dim, depth, heads, patch, qk_norm = parse_vit_spec(backbone,
                                                               width)
            self.vit = ViTBackbone(image_size, dim, depth, heads, patch,
                                   dtype, use_pallas=use_pallas,
                                   qk_norm=qk_norm, pallas_stem=self.fused)
        else:
            self.resnet = ResNetBackbone(width, norm=norm, dtype=dtype,
                                         stem=stem, pallas_stem=self.fused)
        self.net_name = "vit" if is_vit else "resnet"
        self.out_channels = self.net.out_channels

    @property
    def net(self) -> nn.Module:
        """The backbone network, ``resnet`` or ``vit``."""
        return getattr(self, self.net_name)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        if self.fused:
            pre = (self.pre_scale, self.pre_shift, self.perm, True)
            return self.net(image.float().contiguous(), preprocess=pre)
        x = image.float().clamp(0.0, 1.0)
        if self.preprocessing == "scale":
            x = x * 2.0 - 1.0
        elif self.preprocessing == "imagenet":
            mean = torch.tensor([0.485, 0.456, 0.406], device=x.device)
            std = torch.tensor([0.229, 0.224, 0.225], device=x.device)
            x = (x - mean) / std
        else:  # caffe: 0-255 BGR minus the ImageNet channel means
            x = x.flip(-1) * 255.0
            x = x - torch.tensor([103.939, 116.779, 123.68], device=x.device)
        return self.net(x.to(self.dtype))


class BackboneNeck(nn.Module):
    """BatchNorm -> 1x1 conv (tanh) to encoder_dim -> BatchNorm."""

    def __init__(self, in_channels: int, encoder_dim: int,
                 norm: str = "batchnorm", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = make_norm(norm, in_channels, dtype)
        self.conv = Conv(in_channels, encoder_dim, 1, bias=True)
        self.norm2 = make_norm(norm, encoder_dim, dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self.norm1(features)
        x = torch.tanh(self.conv(x, self.dtype))
        return self.norm2(x)
