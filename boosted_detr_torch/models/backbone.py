"""The backbones with their norms and stems, and the neck, in PyTorch.

Counterpart of boosted_detr_tpu/models/backbone.py: ``_AdaptiveGroupNorm``
and ``make_norm`` (:34-64: BatchNorm in eval and training mode, GroupNorm,
and the identity of ``skipinit``), ``WSConv`` (:67-100, as ``Conv`` with
``weight_standardized``), ``PallasPatchifyConv`` (:103-157) as
``PatchifyConv``, ``ConvNormAct`` (:160-194), ``BottleneckBlock``
(:197-226, with ``skip_gain`` under ``skipinit``), ``ResNetBackbone``
(:229-292: the ``conv7``, ``patchify`` and ``patchify8`` stems),
``MBConvBlock`` and ``EfficientNetLiteBackbone`` (:295-358), ``SEBlock``,
``MBConvSEBlock``, ``_round_filters``, ``_round_repeats`` and
``EfficientNetBackbone`` (:361-487, the B4 coefficients with stochastic
depth), ``ViTBlock`` (:490-518), ``ViTBackbone`` (:521-582),
``parse_vit_spec`` (:585-610), ``TinyBackbone`` (:613-628),
``_preprocess_affine`` (:631-643), ``EncoderBackbone`` (:646-731: the
fused-stem route and the plain route for every backbone name) and
``BackboneNeck`` (:734-754).

Activations are NHWC at every module boundary, as in the JAX package. A
convolution hands ``x.permute(0, 3, 1, 2)`` to ``F.conv2d``: that NCHW view
of an NHWC tensor is torch's channels_last layout, so no copy is made. The
EfficientNets' depthwise convolutions are ``F.conv2d(groups=C)`` (cuDNN on
the card): the JAX package leaves them to XLA, no Pallas kernel.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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
from boosted_detr_torch.parallel import mesh as mesh_lib


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
    Flax's mutable collection does.

    Under data parallelism (an active mesh with more than one rank on
    'data') the training statistics are the global batch's, as JAX's on a
    global array: the float32 sum and sum of squares are summed over the
    data group (differentiably: their gradients are summed too) and divided
    by the global count, so every rank normalises alike and updates its
    running statistics alike."""

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
            shard = mesh_lib.data_shard()
            if shard is None:
                mean = xf.mean(axes)
                var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            else:
                count = xf.numel() // xf.shape[-1] * shard[1]
                sums = mesh_lib.all_reduce_sum(torch.stack(
                    [xf.sum(axes), (xf * xf).sum(axes)]), shard[2]) / count
                mean = sums[0]
                var = (sums[1] - mean * mean).clamp_min(0.0)
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


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(num_groups, epsilon=1e-3)`` over the last axis:
    the statistics of each sample and group of channels are taken over
    every axis but the batch axis (H, W and the group's channels of an
    NHWC map; T and the group's channels of [B, T, C] tokens), in float32
    with Flax's fast variance ``max(0, E[x^2] - E[x]^2)``; the normalised
    float32 value is cast to the compute dtype at the end, as in
    ``BatchNorm``. Written out: ``F.group_norm`` takes NCHW and its own
    variance. No running statistics: train and eval compute the same."""

    def __init__(self, num_features: int, num_groups: int,
                 dtype: torch.dtype, eps: float = 1e-3):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{num_features} channels")
        self.dtype = dtype
        self.eps = eps
        self.groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        b, c = x.shape[0], x.shape[-1]
        grouped = xf.reshape(b, -1, self.groups, c // self.groups)
        mean = grouped.mean((1, 3))
        var = ((grouped * grouped).mean((1, 3)) - mean * mean).clamp_min(0.0)
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.repeat_interleave(c // self.groups, -1).reshape(shape)
        var = var.repeat_interleave(c // self.groups, -1).reshape(shape)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)


class AdaptiveGroupNorm(nn.Module):
    """``_AdaptiveGroupNorm`` (backbone.py:34-46): GroupNorm whose group
    count is the largest divisor of the channel count that is at most 32
    (40 channels take 20 groups, 144 take 24), held as the child ``gn`` so
    that the Flax leaves ``norm/gn/{scale,bias}`` map onto it."""

    def __init__(self, num_features: int, dtype: torch.dtype):
        super().__init__()
        groups = next(g for g in range(min(32, num_features), 0, -1)
                      if num_features % g == 0)
        self.gn = GroupNorm(num_features, groups, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(x)


def make_norm(norm: str, num_features: int, dtype: torch.dtype) -> nn.Module:
    """``batchnorm``, ``groupnorm`` or ``skipinit`` (the identity, no
    parameters: the norm-free network standardises its convs' weights
    instead)."""
    if norm == "batchnorm":
        return BatchNorm(num_features, dtype)
    if norm == "groupnorm":
        return AdaptiveGroupNorm(num_features, dtype)
    if norm == "skipinit":
        return nn.Identity()
    raise ValueError(f"unknown norm '{norm}'")


def standardize(weight: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Weight standardisation of an OIHW kernel in float32 (backbone.py:
    90-95): each output channel's fan-in (dims 1, 2, 3) to mean 0, then
    ``* rsqrt(var * fan_in + 1e-4) * gain``, with the population variance
    (``jnp.var``, not torch's default unbiased one)."""
    fan_in = weight[0].numel()
    mean = weight.mean((1, 2, 3), keepdim=True)
    var = weight.var((1, 2, 3), correction=0, keepdim=True)
    w = (weight - mean) * torch.rsqrt(var * fan_in + 1e-4)
    return w * gain.reshape(-1, 1, 1, 1)


def relu6(v: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum(nn.relu(v), 6.0)``: the EfficientNet-lite activation."""
    return torch.relu(v).clamp_max(6.0)


class Conv(nn.Module):
    """Flax ``nn.Conv(padding="SAME", feature_group_count=groups)`` on NHWC
    input in the given dtype, or ``padding="VALID"`` with ``valid=True``.
    The weight is stored as torch's OIHW, [out, in / groups, kh, kw] (a
    depthwise kernel is [C, 1, kh, kw]).

    ``weight_standardized`` is ``WSConv`` (backbone.py:67-100): a ``gain``
    per output channel (ones at init), the ``he_normal`` init, and the
    kernel standardised in float32 (``standardize``) before the cast at
    every use.

    Trap: XLA's SAME padding is asymmetric (``same_padding``). The input is
    padded explicitly with ``lo = total // 2`` before and the rest after,
    and the conv runs with ``padding=0``: for the stride-2 3x3 conv of
    ``BottleneckBlock`` on an even input that is 0 before and 1 after,
    where ``padding=1`` would shift every output by one pixel."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = False, valid: bool = False,
                 groups: int = 1, weight_standardized: bool = False):
        super().__init__()
        if in_channels % groups:
            raise ValueError(f"{groups} groups do not divide {in_channels} "
                             "input channels")
        self.kernel = kernel
        self.stride = stride
        self.valid = valid
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.gain = (nn.Parameter(torch.ones(out_channels))
                     if weight_standardized else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        o, i, kh, kw = self.weight.shape
        init = "he_normal" if self.gain is not None else "lecun_normal"
        variance_scaling_(self.weight, *_INITS[init], i * kh * kw,
                          o * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        if self.gain is not None:
            nn.init.ones_(self.gain)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if not self.valid:
            top, bottom = same_padding(x.shape[1], self.kernel, self.stride)
            left, right = same_padding(x.shape[2], self.kernel, self.stride)
            if top or bottom or left or right:
                x = F.pad(x, (0, 0, left, right, top, bottom))
        weight = self.weight
        if self.gain is not None:
            weight = standardize(weight, self.gain)
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(dtype), bias,
                     self.stride, groups=self.groups)
        return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` on NHWC.

    Trap: as the conv's, the pool's SAME padding is asymmetric (0 before
    and 1 after on an even side). The input is padded explicitly with
    ``-inf``; ``F.max_pool2d(padding=1)`` would pad both sides."""
    top, bottom = same_padding(x.shape[1], window, stride)
    left, right = same_padding(x.shape[2], window, stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


class PatchifyConv(nn.Module):
    """The patchify stem through the hand-written kernels
    (``ops.patchify.PatchifyConvFn``: the forward kernel, and the
    weight-gradient kernel in backward), counterpart of
    ``PallasPatchifyConv``.
    Same parameters as the plain stem conv (``weight``, OIHW, and with
    ``weight_standardized`` the ``gain`` of ``WSConv``), so weights
    interchange between the two routes.

    ``weight_standardized`` (the ``skipinit`` stem) standardises the kernel
    first (``standardize``, float32); the kernels then read standardised
    weights, and the weight gradient flows back through the fold, the
    standardisation and the gain by autograd.

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
                 bias: bool = False, weight_standardized: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, patch, patch))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None
        self.gain = (nn.Parameter(torch.ones(features))
                     if weight_standardized else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        o, i, kh, kw = self.weight.shape
        init = "he_normal" if self.gain is not None else "lecun_normal"
        variance_scaling_(self.weight, *_INITS[init], i * kh * kw,
                          o * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        if self.gain is not None:
            nn.init.ones_(self.gain)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                preprocess=None) -> torch.Tensor:
        weight = self.weight
        if self.gain is not None:
            weight = standardize(weight, self.gain)
        kernel = weight.permute(2, 3, 1, 0)  # OIHW -> HWIO, float32
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


Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


class ConvNormAct(nn.Module):
    """Conv -> norm -> activation (backbone.py:160-194). ``act`` is a
    callable (relu, ``relu6``, ``F.silu`` for swish) or None; ``groups``
    is the conv's group count (C for a depthwise conv). Under ``skipinit``
    the conv is weight-standardised and there is no norm (no ``norm``
    submodule), but the activation still applies. With ``pallas_patchify``
    the conv is the stem kernel (square, stride == kernel, one group)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int = 1, norm: str = "batchnorm",
                 act: Activation = torch.relu,
                 dtype: torch.dtype = torch.float32, groups: int = 1,
                 pallas_patchify: bool = False):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.pallas_patchify = pallas_patchify
        skipinit = norm == "skipinit"
        if pallas_patchify:
            if kernel != stride or groups != 1:
                raise ValueError("the patchify stem needs stride == kernel "
                                 "and one group")
            self.conv = PatchifyConv(in_channels, features, kernel,
                                     weight_standardized=skipinit)
        else:
            self.conv = Conv(in_channels, features, kernel, stride,
                             groups=groups, weight_standardized=skipinit)
        self.norm = None if skipinit else make_norm(norm, features, dtype)

    def forward(self, x, preprocess=None):
        if self.pallas_patchify:
            x = self.conv(x, self.dtype, preprocess)
        elif preprocess is not None:
            raise ValueError("preprocess folding needs the patchify stem")
        else:
            x = self.conv(x, self.dtype)
        if self.norm is not None:
            x = self.norm(x)
        return x if self.act is None else self.act(x)


class BottleneckBlock(nn.Module):
    """ResNet-v1.5 bottleneck: 1x1 reduce -> 3x3 (stride) -> 1x1 expand,
    with a 1x1 projection on the residual where the shape changes. Under
    ``skipinit`` the branch is scaled by the scalar ``skip_gain`` (zero at
    init, SkipInit) before the residual sum."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 norm: str = "batchnorm", dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = features // 4
        self.conv1 = ConvNormAct(in_channels, mid, 1, norm=norm, dtype=dtype)
        # the stride-2 3x3 conv is where SAME's asymmetric padding matters
        self.conv2 = ConvNormAct(mid, mid, 3, stride, norm=norm, dtype=dtype)
        self.conv3 = ConvNormAct(mid, features, 1, norm=norm, act=None,
                                 dtype=dtype)
        if in_channels != features or stride != 1:
            self.proj = ConvNormAct(in_channels, features, 1, stride,
                                    norm=norm, act=None, dtype=dtype)
        else:
            self.proj = None
        self.skip_gain = (nn.Parameter(torch.zeros(()))
                          if norm == "skipinit" else None)

    def reset_parameters(self, generator=None):
        if self.skip_gain is not None:
            nn.init.zeros_(self.skip_gain)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.proj is None else self.proj(x)
        if self.skip_gain is not None:
            y = y * self.skip_gain.to(y.dtype)
        return torch.relu(y + residual)


class ResNetBackbone(nn.Module):
    """ResNet-50-style backbone, stride 32, with the ``conv7`` stem (7x7/s2
    conv to w(64), then a SAME 3x3/s2 max pool, then stages (3, 4, 6, 3)),
    the ``patchify`` stem (4x4/s4 to w(64), the same stages) or the
    ``patchify8`` stem (8x8/s8 to w(128), then stages (4, 6, 3) at strides
    (1, 2, 2)). ``width`` scales channel counts with a floor of 32. A stem
    name other than the two patchify ones is ``conv7``, as in JAX."""

    def __init__(self, width: float = 1.0, norm: str = "batchnorm",
                 dtype: torch.dtype = torch.float32, stem: str = "conv7",
                 pallas_stem: bool = False):
        super().__init__()
        depths = (3, 4, 6, 3)
        in_channels = 3  # RGB

        def w(c):
            return max(32, int(c * width))

        self.pool = False
        if stem == "patchify8":
            self.stem = ConvNormAct(in_channels, w(128), 8, 8, norm=norm,
                                    dtype=dtype, pallas_patchify=pallas_stem)
            stages = list(enumerate(zip(depths[1:], (w(512), w(1024),
                                                     w(2048))), start=1))
            first_strided = 2
        else:
            if stem == "patchify":
                self.stem = ConvNormAct(in_channels, w(64), 4, 4, norm=norm,
                                        dtype=dtype,
                                        pallas_patchify=pallas_stem)
            elif pallas_stem:
                raise ValueError("the fused stem needs a patchify stem")
            else:  # conv7: 7x7/s2, then the SAME 3x3/s2 max pool
                self.stem = ConvNormAct(in_channels, w(64), 7, 2, norm=norm,
                                        dtype=dtype)
                self.pool = True
            stages = list(enumerate(zip(depths, (w(256), w(512), w(1024),
                                                 w(2048)))))
            first_strided = 1
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
        if self.pool:
            x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


def _stochastic_depth(y: torch.Tensor, rate: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keras' ``drop`` layer on a residual branch (backbone.py:414-419):
    one Bernoulli draw per sample with ``keep = 1 - rate``, the kept
    branches scaled by ``1 / keep`` in ``y``'s dtype; the identity when
    ``generator`` is None (eval) or ``rate`` is 0. The bits come from
    ``generator``, so they differ from JAX's; they are drawn on the
    generator's device, so one CPU generator gives a model on the card the
    bits it gives the same model on the CPU. Under data parallelism they
    are the global batch's, this rank's rows."""
    if generator is None or rate == 0.0:
        return y
    keep = 1.0 - rate
    mask = mesh_lib.draw_global(
        lambda shape: torch.rand(shape, generator=generator,
                                 device=generator.device),
        (y.shape[0], 1, 1, 1)) < keep
    return y * (mask.to(y.device, y.dtype) / keep)


class MBConvBlock(nn.Module):
    """EfficientNet-lite MBConv (backbone.py:295-323): 1x1 expand (absent
    when ``expand`` is 1) -> depthwise -> 1x1 project, ReLU6, no
    squeeze-excite; the residual where the stride is 1 and the width
    stays."""

    def __init__(self, in_channels: int, features: int, expand: int = 6,
                 kernel: int = 3, stride: int = 1, norm: str = "batchnorm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_channels * expand
        self.expand = (ConvNormAct(in_channels, mid, 1, norm=norm, act=relu6,
                                   dtype=dtype) if expand != 1 else None)
        self.depthwise = ConvNormAct(mid, mid, kernel, stride, norm=norm,
                                     act=relu6, dtype=dtype, groups=mid)
        self.project = ConvNormAct(mid, features, 1, norm=norm, act=None,
                                   dtype=dtype)
        self.residual = stride == 1 and in_channels == features

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = self.project(self.depthwise(y))
        return y + x if self.residual else y


def _blocks_forward(net: nn.Module, x, *args):
    for name in net.block_names:
        x = getattr(net, name)(x, *args)
    return x


class EfficientNetLiteBackbone(nn.Module):
    """EfficientNet-lite backbone, stride 32 (backbone.py:326-358): a 3x3/s2
    stem to w(32), seven MBConv stages, a 1x1 ``head`` to w(1280), ReLU6
    throughout; ``width`` scales channel counts with a floor of 16."""

    # (features, depth, stride, kernel, expand)
    STAGES = ((16, 1, 1, 3, 1), (24, 2, 2, 3, 6), (40, 2, 2, 5, 6),
              (80, 3, 2, 3, 6), (112, 3, 1, 5, 6), (192, 4, 2, 5, 6),
              (320, 1, 1, 3, 6))

    def __init__(self, width: float = 1.0, norm: str = "batchnorm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def w(c):
            return max(16, int(c * width))

        self.stem = ConvNormAct(3, w(32), 3, 2, norm=norm, act=relu6,
                                dtype=dtype)
        channels = w(32)
        self.block_names = []
        for s, (feats, depth, stride, kernel, expand) in enumerate(
                self.STAGES):
            for i in range(depth):
                name = f"stage{s}_block{i}"
                self.add_module(name, MBConvBlock(
                    channels, w(feats), expand, kernel,
                    stride if i == 0 else 1, norm, dtype))
                self.block_names.append(name)
                channels = w(feats)
        self.head = ConvNormAct(channels, w(1280), 1, norm=norm, act=relu6,
                                dtype=dtype)
        self.out_channels = w(1280)

    def forward(self, x):
        return self.head(_blocks_forward(self, self.stem(x)))


class SEBlock(nn.Module):
    """Squeeze-and-excitation (backbone.py:361-378): the spatial mean in
    float32, cast, a 1x1 ``reduce`` conv with bias, swish, a 1x1 ``expand``
    conv with bias, a float32 sigmoid cast back, and the channel gate.
    ``se_filters`` comes from the block's input width, not the expanded
    one."""

    def __init__(self, channels: int, se_filters: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.reduce = Conv(channels, se_filters, 1, bias=True)
        self.expand = Conv(se_filters, channels, 1, bias=True)

    def forward(self, x):
        s = x.float().mean((1, 2), keepdim=True)
        s = F.silu(self.reduce(s.to(self.dtype), self.dtype))
        s = self.expand(s, self.dtype)
        return x * torch.sigmoid(s.float()).to(x.dtype)


class MBConvSEBlock(nn.Module):
    """The EfficientNet MBConv (backbone.py:381-421): 1x1 expand -> depthwise
    -> squeeze-excite -> 1x1 project, swish, and stochastic depth at
    ``drop_rate`` on the residual branch in training (a ``generator`` is
    given) only."""

    def __init__(self, in_channels: int, features: int, expand: int = 6,
                 kernel: int = 3, stride: int = 1, se_ratio: float = 0.25,
                 drop_rate: float = 0.0, norm: str = "batchnorm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_channels * expand
        self.drop_rate = drop_rate
        self.expand = (ConvNormAct(in_channels, mid, 1, norm=norm,
                                   act=F.silu, dtype=dtype)
                       if expand != 1 else None)
        self.depthwise = ConvNormAct(mid, mid, kernel, stride, norm=norm,
                                     act=F.silu, dtype=dtype, groups=mid)
        self.se = (SEBlock(mid, max(1, int(in_channels * se_ratio)), dtype)
                   if se_ratio else None)
        self.project = ConvNormAct(mid, features, 1, norm=norm, act=None,
                                   dtype=dtype)
        self.residual = stride == 1 and in_channels == features

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = x if self.expand is None else self.expand(x)
        y = self.depthwise(y)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        if not self.residual:
            return y
        return _stochastic_depth(y, self.drop_rate, generator) + x


def _round_filters(filters: float, width: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding (keras semantics)."""
    f = filters * width
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new < 0.9 * f:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth: float) -> int:
    return int(np.ceil(depth * repeats))


class EfficientNetBackbone(nn.Module):
    """EfficientNet with squeeze-excite, swish and compound scaling, stride
    32 (backbone.py:437-487): the reference's default architecture, keras
    ``EfficientNetB4`` at ``width=1.4, depth=1.8``. Block ``k`` of ``total``
    drops its branch at ``drop_connect_rate * k / total`` in training."""

    # B0 base: (filters_out, repeats, stride, kernel, expand)
    BASE = ((16, 1, 1, 3, 1), (24, 2, 2, 3, 6), (40, 2, 2, 5, 6),
            (80, 3, 2, 3, 6), (112, 3, 1, 5, 6), (192, 4, 2, 5, 6),
            (320, 1, 1, 3, 6))

    def __init__(self, width: float = 1.4, depth: float = 1.8,
                 drop_connect_rate: float = 0.2, norm: str = "batchnorm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        channels = _round_filters(32, width)
        self.stem = ConvNormAct(3, channels, 3, 2, norm=norm, act=F.silu,
                                dtype=dtype)
        total = sum(_round_repeats(r, depth) for _, r, _, _, _ in self.BASE)
        done = 0
        self.block_names = []
        for s, (feats, repeats, stride, kernel, expand) in enumerate(
                self.BASE):
            feats = _round_filters(feats, width)
            for i in range(_round_repeats(repeats, depth)):
                name = f"stage{s}_block{i}"
                self.add_module(name, MBConvSEBlock(
                    channels, feats, expand, kernel, stride if i == 0 else 1,
                    se_ratio=0.25, drop_rate=drop_connect_rate * done / total,
                    norm=norm, dtype=dtype))
                self.block_names.append(name)
                channels = feats
                done += 1
        self.out_channels = _round_filters(1280, width)
        self.head = ConvNormAct(channels, self.out_channels, 1, norm=norm,
                                act=F.silu, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.head(_blocks_forward(self, self.stem(x), generator))


class TinyBackbone(nn.Module):
    """Minimal stride-32 conv stack (backbone.py:613-628): five 3x3/s2
    ConvNormAct (relu) to ``min(feats * 2**i, 256)`` channels, ``feats =
    max(8, int(32 * width))``; the JAX tests' cheap model."""

    def __init__(self, width: float = 1.0, norm: str = "batchnorm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        feats = max(8, int(32 * width))
        channels = 3
        for i in range(5):  # 2^5 = stride 32
            out = min(feats * 2 ** i, 256)
            self.add_module(f"conv{i}", ConvNormAct(channels, out, 3, 2,
                                                    norm=norm, dtype=dtype))
            channels = out
        self.out_channels = channels

    def forward(self, x):
        for i in range(5):
            x = getattr(self, f"conv{i}")(x)
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
                                       qk_norm=qk_norm,
                                       post_softmax_mask=False)
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
    patchify stem: JAX's condition, backbone.py:665-667): the raw float32
    image goes straight to the stem kernel, which clips it, and the
    preprocessing affine is folded into the stem weights. Plain route:
    clip, preprocess and cast here, then the ordinary stem conv.
    ``backbone`` is ``resnet`` (submodule ``resnet``), ``efficientnet_lite``
    (``effnet``), ``efficientnet_b4`` (``effnet_b4``: the B4 coefficients,
    width ``1.4 * width``, depth 1.8, stochastic depth in training),
    ``tiny`` (``tiny``) or ``vit``/``vit_*`` (``vit``, whose blocks take
    the fused attention when ``use_pallas``; it needs ``image_size``); any
    other name raises ``ValueError``. ``out_channels`` is the width the
    neck receives."""

    def __init__(self, backbone: str = "resnet", width: float = 1.0,
                 norm: str = "batchnorm", dtype: torch.dtype = torch.float32,
                 stem: str = "conv7", preprocessing: str = "scale",
                 use_pallas_stem: bool = False, *, use_pallas: bool = False,
                 image_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        # exact-prefix match, as in JAX: "vitp32" is not a ViT
        is_vit = backbone == "vit" or backbone.startswith("vit_")
        self.dtype = dtype
        self.preprocessing = preprocessing
        self.fused = use_pallas_stem and (
            is_vit or (backbone == "resnet" and stem.startswith("patchify")))
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
            self.net_name = "vit"
            net = ViTBackbone(image_size, dim, depth, heads, patch, dtype,
                              use_pallas=use_pallas, qk_norm=qk_norm,
                              pallas_stem=self.fused)
        elif backbone == "resnet":
            self.net_name = "resnet"
            net = ResNetBackbone(width, norm=norm, dtype=dtype, stem=stem,
                                 pallas_stem=self.fused)
        elif backbone == "efficientnet_lite":
            self.net_name = "effnet"
            net = EfficientNetLiteBackbone(width, norm=norm, dtype=dtype)
        elif backbone == "efficientnet_b4":
            # ``width`` multiplies the B4 width coefficient
            self.net_name = "effnet_b4"
            net = EfficientNetBackbone(1.4 * width, 1.8, norm=norm,
                                       dtype=dtype)
        elif backbone == "tiny":
            self.net_name = "tiny"
            net = TinyBackbone(width, norm=norm, dtype=dtype)
        else:
            raise ValueError(f"unknown backbone '{backbone}'")
        self.add_module(self.net_name, net)
        self.out_channels = net.out_channels

    @property
    def net(self) -> nn.Module:
        """The backbone network: ``resnet``, ``effnet``, ``effnet_b4``,
        ``tiny`` or ``vit``."""
        return getattr(self, self.net_name)

    @property
    def needs_generator(self) -> bool:
        """True when the training forward draws random bits (the B4's
        stochastic depth), so that it needs a generator even at
        ``dropout_rate=0``."""
        return self.net_name == "effnet_b4"

    def forward(self, image: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the stochastic-depth bits of a training
        forward (``efficientnet_b4``); None is the eval forward."""
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
        x = x.to(self.dtype)
        if self.needs_generator:
            return self.net(x, generator)
        return self.net(x)


class BackboneNeck(nn.Module):
    """Norm -> 1x1 conv (tanh) to encoder_dim -> norm. A ``skipinit``
    backbone's neck takes GroupNorm (backbone.py:744-748)."""

    def __init__(self, in_channels: int, encoder_dim: int,
                 norm: str = "batchnorm", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        norm = "groupnorm" if norm == "skipinit" else norm
        self.norm1 = make_norm(norm, in_channels, dtype)
        self.conv = Conv(in_channels, encoder_dim, 1, bias=True)
        self.norm2 = make_norm(norm, encoder_dim, dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = self.norm1(features)
        x = torch.tanh(self.conv(x, self.dtype))
        return self.norm2(x)
