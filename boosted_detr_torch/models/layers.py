"""Transformer building blocks in PyTorch.

Counterpart of boosted_detr_tpu/models/layers.py:45-310
(``trig_positional_init``, ``MultiheadAttention``, ``AttentionBlock``,
``FeedForwardBlock``, ``EncoderBlock``, ``ImageEncoder``, ``DecoderPrep``,
``DecoderBlock``). Submodules and parameters carry the Flax names, so that
``bridge.load_flax_variables`` maps one tree onto the other leaf by leaf.
Tokens are ``[B, T, D]`` as in the JAX package.

Parameters are float32 and cast to the compute dtype at use, as Flax does
with ``dtype=bfloat16``. Dropout sits where the JAX blocks have it, after
the attention (layers.py:159) and after the FFN (:184). Each forward takes
a ``generator``: ``None`` is the JAX ``deterministic=True`` (no dropout);
a ``torch.Generator`` on the activations' device draws the dropout bits,
never the global RNG.

``use_pallas=True`` (``ModelConfig.use_pallas_attention``) sends an MHA
through the fused attention kernels (``ops/attention.py``, the K3 kernels
on the card), with the TPU kernel's numerics: q scaled before the dot and
the probabilities kept in float32 through P.V, where the plain route
divides the logits and casts the probabilities to the compute dtype
first. ``qk_norm`` is the per-head bias-free LayerNorm of q and k that the
ViT blocks may use. An attention ``mask`` (1 = keep) multiplies the
probabilities after the softmax without renormalising them
(``post_softmax_mask``, the reference's rule) or masks the logits before
it; a masked attention takes the plain route.

Under tensor parallelism (parallel/sharding.py) a split ``Dense`` sums
over the mesh's 'model' group as its side of the Megatron pair needs, and
a split MHA runs its local heads. Dropout draws its bits for the global
batch under data parallelism (``mesh.draw_global``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from boosted_detr_torch.ops import attention
from boosted_detr_torch.parallel import mesh as mesh_lib

# Flax's truncated-normal variance scaling divides the std by the std of a
# unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(t: torch.Tensor, scale: float, mode: str, fan_in: int,
                      fan_out: int,
                      generator: Optional[torch.Generator] = None) -> None:
    """Flax's ``variance_scaling(scale, mode, "truncated_normal")`` drawn
    with a torch generator (glorot_normal = (1, fan_avg), he_normal =
    (2, fan_in), lecun_normal = (1, fan_in)). Same distribution, not the
    same numbers: the bridge carries trained weights across."""
    fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
    std = math.sqrt(scale / fan) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


_INITS = {"glorot_normal": (1.0, "fan_avg"), "he_normal": (2.0, "fan_in"),
          "lecun_normal": (1.0, "fan_in")}


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout(rate)``: keeps each value with probability
    ``1 - rate`` and scales the kept ones by dividing by ``1 - rate`` in
    ``x``'s dtype; the identity when ``generator`` is None or ``rate`` is
    0. The bits come from ``generator``, so they differ from JAX's; under
    data parallelism they are the global batch's, this rank's rows."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = mesh_lib.draw_global(
        lambda shape: torch.rand(shape, generator=generator,
                                 device=x.device), x.shape) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator] = None) -> None:
    """Re-draws every parameter of ``module`` from ``generator``."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``x @ kernel + bias`` in the given dtype. The
    weight is stored as torch's ``[out, in]``.

    ``tp_split`` (set by ``parallel.sharding.shard_module``) is None, or
    ("column", group): this rank's output features, the input's gradient
    summed over the group; or ("row", group): this rank's input features,
    the partial products summed over the group in float32, then the bias
    added once."""

    tp_split = None

    def __init__(self, in_features: int, out_features: int,
                 init: str = "lecun_normal"):
        super().__init__()
        self.init_name = init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        out_f, in_f = self.weight.shape
        variance_scaling_(self.weight, *_INITS[self.init_name], in_f, out_f,
                          generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.tp_split is None:
            return F.linear(x.to(dtype), self.weight.to(dtype),
                            self.bias.to(dtype))
        kind, group = self.tp_split
        if kind == "column":
            x = mesh_lib.sum_backward(x, group)
            return F.linear(x.to(dtype), self.weight.to(dtype),
                            self.bias.to(dtype))
        partial = F.linear(x.to(dtype), self.weight.to(dtype)).float()
        return (mesh_lib.sum_forward(partial, group).to(dtype)
                + self.bias.to(dtype))


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(epsilon, use_bias=bias, dtype=float32)`` over the
    last axis.

    Trap: the JAX blocks normalise in float32 with eps 1e-3 (torch's default
    is 1e-5), and Flax takes the variance as E[x^2] - E[x]^2 (clipped at 0),
    not torch's two-pass E[(x - E[x])^2]. Both are reproduced here, so the
    remaining difference is float32 summation order. ``bias=False`` is the
    scale-only norm of ``qk_norm``."""

    def __init__(self, dim: int, eps: float, bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return y if self.bias is None else y + self.bias


def trig_positional_init(num_positions: int, dim: int) -> np.ndarray:
    """Positional-encoding init of the JAX package (layers.py:45-55):
    ``denom = 2*(1+d)/dim``; position k uses sin(k/denom) when k is odd and
    cos(k/denom) when k is even."""
    k = np.arange(num_positions, dtype=np.float64)[:, None]
    d = np.arange(dim, dtype=np.float64)[None, :]
    denom = 2.0 * (1.0 + d) / dim
    odd_k = k % 2
    even_k = (k + 1) % 2
    return (odd_k * np.sin(k / denom) + even_k * np.cos(k / denom)).astype(
        np.float32)


class MultiheadAttention(nn.Module):
    """MHA of layers.py:58-140.

    The plain route (layers.py:120-140) is tensor code on purpose, not
    ``scaled_dot_product_attention``:
    - the logits are float32 from q and k in the compute dtype (bf16 values
      are exact in float32, so the float32 matmul is the JAX einsum with
      ``preferred_element_type=float32``), divided by sqrt(head_dim);
    - softmax is float32; the probabilities are cast to the compute dtype
      before P.V, which again accumulates in float32;
    - heads merge in the standard [B, T, H, D] -> [B, T, H*D] order, not
      the reference's scrambled reshape (layers.py:24-30).
    The fused route (``use_pallas``, layers.py:104-118) folds the heads
    into contiguous [B*H, T, D], calls ``attention.fused_attention`` (the
    K3 kernels on the card), unfolds and casts to the compute dtype before
    the output projection. ``qk_norm`` (layers.py:91-102) normalises q and
    k over head_dim in float32 (eps 1e-6, scale only) on either route.

    ``mask`` (broadcastable to the logits [B, H, Tq, Tk], 1 = keep) sends
    the call down the plain route (layers.py:104). With
    ``post_softmax_mask`` it multiplies the float32 probabilities after
    the softmax, with no renormalisation (the reference's quirk,
    layers.py:130-133); without, the masked logits become -1e30 before it
    (:125-126).
    """

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 kv_dim: Optional[int] = None, use_pallas: bool = False,
                 qk_norm: bool = False, post_softmax_mask: bool = True):
        super().__init__()
        kv_dim = kv_dim or dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.post_softmax_mask = post_softmax_mask
        proj = self.head_dim * num_heads
        self.query_projection = Dense(dim, proj, "glorot_normal")
        self.key_projection = Dense(kv_dim, proj, "glorot_normal")
        self.value_projection = Dense(kv_dim, proj, "glorot_normal")
        if qk_norm:
            self.q_norm = LayerNorm(self.head_dim, 1e-6, bias=False)
            self.k_norm = LayerNorm(self.head_dim, 1e-6, bias=False)
        else:
            self.q_norm = self.k_norm = None
        self.output_projection = Dense(proj, dim, "glorot_normal")

    def forward(self, query, key, value, mask=None):
        dt = self.dtype

        def split(x):  # [B, T, H*D] -> [B, H, T, D]
            b, t, _ = x.shape
            return x.reshape(b, t, self.num_heads, self.head_dim).transpose(
                1, 2)

        q = split(self.query_projection(query, dt))
        k = split(self.key_projection(key, dt))
        v = split(self.value_projection(value, dt))
        if self.q_norm is not None:
            q = self.q_norm(q).to(dt)
            k = self.k_norm(k).to(dt)
        b, _, tq, _ = q.shape
        if self.use_pallas and mask is None:
            def fold(x):  # [B, H, T, D] -> contiguous [B*H, T, D]
                return x.reshape(b * self.num_heads, x.shape[2],
                                 self.head_dim).contiguous()

            out = attention.fused_attention(fold(q), fold(k), fold(v))
            out = out.reshape(b, self.num_heads, tq, self.head_dim)
        else:
            logits = q.float() @ k.float().transpose(-1, -2)
            logits = logits / math.sqrt(self.head_dim)
            if mask is not None and not self.post_softmax_mask:
                logits = torch.where(mask.bool(), logits,
                                     logits.new_tensor(-1e30))
            probs = torch.softmax(logits, dim=-1)
            if mask is not None and self.post_softmax_mask:
                probs = probs * mask.to(probs.dtype)
            out = probs.to(dt).float() @ v.float()  # [B, H, Tq, D], f32 sums
        out = out.transpose(1, 2).reshape(b, tq, -1).to(dt)
        return self.output_projection(out, dt)


class AttentionBlock(nn.Module):
    """MHA + dropout + residual + LayerNorm (layers.py:143-165); the
    residual add and the norm are float32."""

    def __init__(self, dim: int, num_heads: int, eps: float,
                 dtype: torch.dtype, kv_dim: Optional[int] = None,
                 dropout_rate: float = 0.1, use_pallas: bool = False,
                 post_softmax_mask: bool = True):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.attention = MultiheadAttention(
            dim, num_heads, dtype, kv_dim, use_pallas,
            post_softmax_mask=post_softmax_mask)
        self.layer_norm = LayerNorm(dim, eps)

    def forward(self, query, key, value, generator=None, mask=None):
        attn = dropout(self.attention(query, key, value, mask),
                       self.dropout_rate, generator)
        x = query.float() + attn.float()
        return self.layer_norm(x).to(self.dtype)


class FeedForwardBlock(nn.Module):
    """Constant-width Dense(relu) -> Dense + dropout + residual + LayerNorm
    (layers.py:168-188)."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.dense_relu = Dense(dim, dim, "glorot_normal")
        self.dense_linear = Dense(dim, dim, "glorot_normal")
        self.layer_norm = LayerNorm(dim, eps)

    def forward(self, x, generator=None):
        h = torch.relu(self.dense_relu(x, self.dtype))
        h = dropout(self.dense_linear(h, self.dtype), self.dropout_rate,
                    generator)
        out = x.float() + h.float()
        return self.layer_norm(out).to(self.dtype)


class EncoderBlock(nn.Module):
    """Self-attention with Q = K = features + pos and V = features, then the
    FFN (layers.py:191-216).

    Trap: the residual stream is ``features + pos`` too, because the block
    passes the positional-augmented tensor as the attention block's query
    (layers.py:204-213)."""

    def __init__(self, dim: int, num_heads: int, eps: float,
                 dtype: torch.dtype, dropout_rate: float = 0.1,
                 use_pallas: bool = False, post_softmax_mask: bool = True):
        super().__init__()
        self.self_attention = AttentionBlock(
            dim, num_heads, eps, dtype, dropout_rate=dropout_rate,
            use_pallas=use_pallas, post_softmax_mask=post_softmax_mask)
        self.ffn = FeedForwardBlock(dim, eps, dtype, dropout_rate)

    def forward(self, features, positional, generator=None):
        qk = features + positional.to(features.dtype)
        features = self.self_attention(qk, qk, features, generator)
        return self.ffn(features, generator)


class ImageEncoder(nn.Module):
    """Flatten [B, R, C, D] to tokens, add the learned positional encoding,
    run the encoder blocks (layers.py:219-252). Returns (tokens [B, R*C, D],
    positional [B, R*C, D])."""

    def __init__(self, grid: tuple, dim: int, num_blocks: int,
                 num_heads: int, eps: float, dtype: torch.dtype,
                 dropout_rate: float = 0.1, use_pallas: bool = False,
                 post_softmax_mask: bool = True):
        super().__init__()
        self.grid = tuple(grid)
        self.dim = dim
        self.num_blocks = num_blocks
        self.positional_encoding = nn.Parameter(
            torch.empty(grid[0] * grid[1], dim))
        for i in range(num_blocks):
            self.add_module(f"block_{i}", EncoderBlock(
                dim, num_heads, eps, dtype, dropout_rate, use_pallas,
                post_softmax_mask))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.positional_encoding.copy_(torch.from_numpy(
                trig_positional_init(*self.positional_encoding.shape)))

    def forward(self, features, generator=None):
        b, r, c, d = features.shape
        if (r, c) != self.grid:
            raise ValueError(f"encoder built for a {self.grid} grid, got "
                             f"{(r, c)}")
        tokens = features.reshape(b, r * c, d)
        pos = self.positional_encoding[None].expand(b, r * c, d)
        for i in range(self.num_blocks):
            tokens = getattr(self, f"block_{i}")(tokens, pos, generator)
        return tokens, pos


class DecoderPrep(nn.Module):
    """Object queries and the encoder key (layers.py:255-279):
    ``encoder_key = encoder_value + positional`` in float32, and the
    zero-initialised queries broadcast over the batch."""

    def __init__(self, num_object_preds: int, decoder_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.object_queries = nn.Parameter(
            torch.zeros(num_object_preds, decoder_dim))

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.object_queries)

    def forward(self, encoder_tokens, positional_tokens):
        b = encoder_tokens.shape[0]
        encoder_key = (encoder_tokens.float()
                       + positional_tokens.float()).to(self.dtype)
        queries = self.object_queries[None].to(self.dtype).expand(
            b, *self.object_queries.shape)
        return encoder_tokens, queries, encoder_key, queries


class DecoderBlock(nn.Module):
    """Optional self-attention (plain Q = K = V), cross-attention against
    the encoder key/value, FFN (layers.py:282-310). Trap: decoder block 0
    has no self-attention (``self_attention=False``)."""

    def __init__(self, dim: int, num_heads: int, eps: float,
                 dtype: torch.dtype, self_attention: bool = True,
                 encoder_dim: Optional[int] = None,
                 dropout_rate: float = 0.1, use_pallas: bool = False,
                 post_softmax_mask: bool = True):
        super().__init__()
        if self_attention:
            self.self_attention = AttentionBlock(
                dim, num_heads, eps, dtype, dropout_rate=dropout_rate,
                use_pallas=use_pallas, post_softmax_mask=post_softmax_mask)
        else:
            self.self_attention = None
        self.cross_attention = AttentionBlock(
            dim, num_heads, eps, dtype, kv_dim=encoder_dim,
            dropout_rate=dropout_rate, use_pallas=use_pallas,
            post_softmax_mask=post_softmax_mask)
        self.ffn = FeedForwardBlock(dim, eps, dtype, dropout_rate)

    def forward(self, encoder_value, decoder_features, encoder_key,
                generator=None):
        if self.self_attention is not None:
            decoder_features = self.self_attention(
                decoder_features, decoder_features, decoder_features,
                generator)
        decoder_features = self.cross_attention(decoder_features, encoder_key,
                                                encoder_value, generator)
        return self.ffn(decoder_features, generator)
