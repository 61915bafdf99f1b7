"""Fused attention (K3): the hand-written Hopper kernels and their plain
PyTorch versions.

Counterpart of boosted_detr_tpu/ops/pallas_attention.py:
``fused_attention`` (:345-358) and ``fused_attention_with_lse``
(:333-342), with the forward kernel ``_attention_kernel`` of
``_fused_attention_fwd_impl`` (:45-80, :97-135) and the kernels ``_dq_kernel``
and ``_dkdv_kernel`` of ``_fused_attention_bwd_impl`` (:138-199,
:202-287). Contract: q [BH, Tq, D], k and v [BH, Tk, D], one dtype
(float32 or bfloat16), no mask; out [BH, Tq, D] in q's dtype and the
per-row log-sum-exp of the scaled logits, lse [BH, Tq] float32.

The arithmetic is the TPU kernels', not the plain MHA's
(models/layers.py): q is scaled by 1/sqrt(D) before the dot, and the
probabilities stay float32 through P.V; ``denom`` is clamped at 1e-30 and
``lse = m + log(max(denom, 1e-30))``. The gradient rebuilds p from the lse:
``p = exp(qs.k - lse)``, ``ds = p (dO.v - delta)`` with ``delta =
rowsum(dO * O) - g_lse``, ``dq = scale ds.k``, ``dk = ds^T qs``, ``dv =
p^T dO``. ``delta`` is one plain torch pass, as JAX leaves it to XLA.

The kernels, ``csrc/attention.cu``, are CUDA C++ for ``sm_90a``, built by
nvcc at first use and loaded with ctypes (``ops/build.py``), for D = 32,
64, 80 and 128, and for D = 128 n (n >= 2) in 128-wide chunks. Any other
head dim is padded with zeros (``_padded``): up to the next of 32, 64, 80
and 128 at most 128, else to the next multiple of 128 (D = 160 to 256), as
the TPU kernel pads D to a multiple of 128; the launch is given the true
1/sqrt(D) and the outputs are sliced back. ViT-Huge's D = 80 runs at its
true width (the TPU pads it to 128), in both dtypes: the wrappers make no
padded copy and no slice there. Past 128 the bf16 kernels at
D = 256 and 384 (``RESIDENT_MAX_HEAD_DIM``) own all D of their rows'
output and compute the logits once a streamed tile, summed over the head
dim 16 dims a step in order. The forward runs Hopper's warpgroup products
(``wgmma``, both S = q k^T and P.V, p as the A operand from registers) on
tiles that one thread loads with TMA into rings of stages, q resident; at
D = 256 each of its two warpgroups owns 64 query rows and all 256 dims, at
D = 384 both take the same 64 rows and half the dims each. dq and dk/dv
run 8 warps a block over 64 rows, the block's own rows resident in shared
memory, p passed to the partner warp through shared memory. Every other
wide kernel (float32, and the bf16 forward, dq and dk/dv from D = 512 on)
takes a grid axis over the output's 128-wide chunks: each block owns one
chunk of out, dq, dk or dv, and computes the logits (and dP) over the
whole head dim, one staged 128-wide chunk after another in the same order
in every block, so all blocks of a row group compute the same p and ds.
Both routes sum in that order, so the emulations below describe them
both, at D = 128 and past it too (``wide_forward_kernel`` and
``wide_gradient_kernels`` name the route); ``wgmma`` may sum inside a
16-dim step otherwise than ``mma.sync``, which the emulation does not
model either. They take contiguous [BH, T, D] tensors: the MHA folds its
heads into that layout before the call (one copy each of q, k and v), so
the kernels need no strides. float32 inputs multiply in float32 on the
CUDA cores (the tensor cores would make them TF32; 20 dims a thread at
D = 80, 32 at 128), but dq and dk/dv at a padded ``TF32_HEAD_DIM`` (256)
run on the tensor cores at float32's accuracy: each product as three
TF32 products (hi hi + hi lo + lo hi, ``_tf32_parts``: hi the word with
its low 13 bits dropped, as the tensor cores read it, lo the same of the
remainder), ``attn_dq_wide_tf32_kernel`` and
``attn_dkdv_wide_tf32_kernel`` after a split pass into scratch the
wrapper allocates (``wide_gradient_kernels(d, dtype)`` names the route;
``attention_dq_emulation`` and ``attention_dkdv_emulation`` take their
arithmetic for float32 there). bfloat16 inputs run on the tensor
cores: dq at D = 32 and dk/dv at D <= 64 where the other operand's
stream is short (at most
``SHORT_STREAM`` rows: the DETR decoder's attention) on ``mma.sync`` with
bf16 operands and float32 sums, a block's 64 rows in registers, the other
operand streamed in 64-row tiles two deep with ``cp.async`` (16 bytes at
a time, so q, k, v and g must be aligned to that or the wrapper raises;
the TMA kernels need the same); the forward, and dq and dk/dv otherwise,
up to D = 128 on ``wgmma`` and TMA (``attn_fwd_wgmma_kernel``,
``attn_dq_wgmma_kernel``, ``attn_dkdv_wgmma_kernel``: warpgroups of 64
rows, two a block but one in the forward at D <= 64, the block's rows
resident, the streamed tiles in a ring of stages, p and ds from registers
as the A operand of the second products, the sums in the ``mma.sync``
kernels' order, so that the same emulations describe both; rows staged 64
dims wide at D <= 64, TMA's zeros past dim 32 at D = 32;
``narrow_forward_kernel`` and ``narrow_gradient_kernels`` name the route
up to 128, ``kernel_occupancy`` gives their blocks an SM); the wide
forward at D = 256 and 384 on ``wgmma`` as above. The exact bf16 q.k product is
scaled as a float32 logit, and p and ds, float32 on the TPU, enter the
second products as two bf16 values each (hi + lo, ~16 mantissa bits): one
bf16 rounding of p moves a tenth of the forward's outputs past one ulp.
The forward's online softmax takes its max per 64-key tile and sums the
denominator from the float32 p. On this card operations bound all three
(4, 6 and 8 BH Tq Tk D); at D = 32 the one ex2 a query-key pair sets a
floor about twice the forward's tensor-core bound.
``attention_fwd_emulation``, ``attention_dq_emulation`` and
``attention_dkdv_emulation`` repeat that arithmetic in plain PyTorch for
the CPU tests. Each ``attention_*`` wrapper runs its plain version
(``attention_*_reference``) on CPU tensors only; a CUDA tensor launches
the kernel or raises, and each launch adds one to the wrapper's
``launches``. ``FusedAttentionFn`` is the custom VJP: the forward saves
(q, k, v, out, lse) and the backward runs dq and dk/dv through the same
wrappers, so the CPU tests reach the same lse-rebuilt backward the card
runs. The forward is the registered op ``boosted_detr::attention_fwd``
(``torch.library.custom_op``), so that ``torch.export`` keeps it in an
exported program (serving.py): the checks, the padding, the alignment
test and the launch run in its body at call time, and its fake gives
out and lse from symbolic sizes. The backward wrappers are not exported
and stay plain functions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

# The head dims the kernels are built for; past the last they take
# multiples of it, in chunks of it.
SUPPORTED_HEAD_DIMS = (32, 64, 80, 128)
CHUNK = SUPPORTED_HEAD_DIMS[-1]
# The widest head dim whose bf16 forward, dq and dk/dv keep the block's
# rows resident in shared memory (csrc/attention.cu, RESIDENT_MAX_NC
# chunks); wider ones take the chunked kernels.
RESIDENT_MAX_HEAD_DIM = 3 * CHUNK
# The longest stream of the other operand (Tk for dq, Tq for dk/dv) that
# bf16 dq at D = 32 and dk/dv at D <= 64 run on the ``mma.sync`` kernels
# (csrc/attention.cu, SHORT_STREAM); longer ones take the wgmma kernels.
SHORT_STREAM = 128
# The head dim at which float32 dq and dk/dv run on the tensor cores as
# three TF32 products a product (csrc/attention.cu, TF32_D); float32 at
# other head dims stays on the CUDA cores.
TF32_HEAD_DIM = 2 * CHUNK
# The bits of a float32 word that a TF32 operand keeps (0xffffe000).
_TF32_HI = -(1 << 13)
# streamed rows a tile of the TF32 kernels, dims (rows) a step, and dims a
# slab: the span over which the tensor cores sum before a sum is added in
# registers
_TF32_TILE, _TF32_STEP, _TF32_SLAB = 32, 8, 32
_DTYPES = (torch.float32, torch.bfloat16)
_FLOOR = 1e-30


def _scale(d: int) -> float:
    return 1.0 / float(d) ** 0.5


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"fused attention takes q [BH, Tq, D] and k, v "
                         f"[BH, Tk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[2] != k.shape[2]):
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if 0 in q.shape or 0 in k.shape:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"q, k and v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_grad(q, g, lse, delta):
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    rows = tuple(q.shape[:2])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != rows or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {rows} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: (out in q's dtype, lse [BH, Tq] float32), with a
    full float32 softmax of the logits of q scaled first."""
    _check(q, k, v)
    qs = q.float() * _scale(q.shape[-1])
    logits = qs @ k.float().transpose(1, 2)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True).clamp_min(_FLOOR)
    out = (p @ v.float()) / denom
    return out.to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def _rebuilt(q, k, v, g, lse, delta):
    """qs, p rebuilt from the lse, and ds, all float32."""
    qs = q.float() * _scale(q.shape[-1])
    p = torch.exp(qs @ k.float().transpose(1, 2) - lse[..., None])
    dp = g.float() @ v.float().transpose(1, 2)
    return qs, p, p * (dp - delta[..., None])


def attention_dq_reference(q, k, v, g, lse, delta) -> torch.Tensor:
    """The plain dq: ``scale * ds @ k`` in q's dtype."""
    _check(q, k, v)
    _check_grad(q, g, lse, delta)
    _, _, ds = _rebuilt(q, k, v, g, lse, delta)
    return ((ds @ k.float()) * _scale(q.shape[-1])).to(q.dtype)


def attention_dkdv_reference(q, k, v, g, lse, delta
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain (dk, dv): ``ds^T @ qs`` and ``p^T @ g`` in k's and v's
    dtypes."""
    _check(q, k, v)
    _check_grad(q, g, lse, delta)
    qs, p, ds = _rebuilt(q, k, v, g, lse, delta)
    dk = ds.transpose(1, 2) @ qs
    dv = p.transpose(1, 2) @ g.float()
    return dk.to(k.dtype), dv.to(v.dtype)


_TILE = 64  # rows of the streamed operand per step of the bf16 kernels
# queries a tile of the bf16 dk/dv kernel past D = 128
_DKDV_WIDE_TILE = 32
_LOG2E = 1.4426950408889634


def _logits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T in float32 as the tensor-core kernels sum it: past D = 128
    one 128-wide chunk of the head dim after another, in order, as each
    block of the chunked kernels stages them (the resident kernels sum the
    same 16-dim steps in the same order)."""
    d = a.shape[-1]
    if d <= CHUNK:
        return a @ b.transpose(1, 2)
    out = a[..., :CHUNK] @ b[..., :CHUNK].transpose(1, 2)
    for c0 in range(CHUNK, d, CHUNK):
        out = out + (a[..., c0:c0 + CHUNK]
                     @ b[..., c0:c0 + CHUNK].transpose(1, 2))
    return out


def _two_bf16(x: torch.Tensor, split: bool) -> Tuple[torch.Tensor, ...]:
    """float32 x as the bf16 values that stand for it in a tensor-core
    product: hi = bf16(x) and, with ``split``, lo = bf16(x - hi)."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x as the tensor cores read it as TF32: the low 13 bits of
    each word dropped (a truncation toward zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & _TF32_HI).view(torch.float32)


def _tf32_parts(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x as the two TF32 values that stand for it in the float32
    tensor-core kernels: hi = x with its low 13 bits dropped, lo = the same
    of x - hi (which is exact). |x - hi - lo| <= 2^-21 |x|."""
    hi = _tf32(x)
    return hi, _tf32(x.float() - hi)


def _tf32_product(a_parts, b_parts, out: torch.Tensor) -> torch.Tensor:
    """out + a @ b as the TF32 kernels sum it: 8 rows of the contraction a
    step in order, each step hi hi, then hi lo, then lo hi, added one
    product at a time into the float32 sum (a [.., M, K], b [.., K, N],
    each as its ``_tf32_parts``)."""
    (ah, al), (bh, bl) = a_parts, b_parts
    for c0 in range(0, ah.shape[-1], _TF32_STEP):
        c = slice(c0, c0 + _TF32_STEP)
        out = out + ah[..., c] @ bh[..., c, :]
        out = out + ah[..., c] @ bl[..., c, :]
        out = out + al[..., c] @ bh[..., c, :]
    return out


def _tf32_logits(a: torch.Tensor, b: torch.Tensor,
                 by_slab: bool) -> torch.Tensor:
    """a @ b^T over the head dim as the TF32 kernels sum it: in one sum
    (``_tf32_product``), or with ``by_slab`` each 32-dim slab in a sum of
    its own, the slabs added in order."""
    a_parts = _tf32_parts(a)
    b_parts = _tf32_parts(b.transpose(1, 2))
    zero = torch.zeros(a.shape[:2] + (b.shape[1],), device=a.device)
    if not by_slab:
        return _tf32_product(a_parts, b_parts, zero)
    out = None
    for c0 in range(0, a.shape[-1], _TF32_SLAB):
        c = slice(c0, c0 + _TF32_SLAB)
        part = _tf32_product([t[..., c] for t in a_parts],
                             [t[..., c, :] for t in b_parts], zero)
        out = part if out is None else out + part
    return out


def _tf32_tiles(q, k, v, g, lse, delta, over_keys: bool, scale: float):
    """What the float32 tensor-core gradient kernels compute, tile by tile
    (``_emulated_tiles``' counterpart): S and dP over the head dim as
    ``_tf32_logits`` sums them (dq: S in one sum, dP slab by slab; dk/dv:
    both slab by slab), p = exp(s scale - lse) and ds = p (dp - delta)
    float32. Yields (slice of the streamed rows, p, ds), the stream
    running over 32-row key tiles (dq) or query tiles (dk/dv)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    rows = k.shape[1] if over_keys else q.shape[1]
    for r0 in range(0, rows, _TF32_TILE):
        tile = slice(r0, r0 + _TF32_TILE)
        qs, ks = (slice(None), tile) if over_keys else (tile, slice(None))
        p = torch.exp(_tf32_logits(qf[:, qs], kf[:, ks], not over_keys)
                      * scale - lse[:, qs, None])
        ds = p * (_tf32_logits(gf[:, qs], vf[:, ks], True)
                  - delta[:, qs, None])
        yield tile, p, ds


def _emulated_tiles(q, k, v, g, lse, delta, over_keys: bool, split: bool,
                    scale: float):
    """What the tensor-core gradient kernels compute, tile by tile: the
    exact product of the inputs (bf16 on the card) summed in float32, the
    scale applied to the float32 logit, and (p, ds) as their bf16 parts.
    Yields (slice of the streamed rows, parts of p, parts of ds), the
    stream running over 64-row key tiles (dq) or query tiles (dk/dv; 32
    rows past D = 128). The kernels add each 16-row step of a tile into
    their sums in order, so a tile's size moves no kernel's order of sums:
    the resident kernels (32-row tiles) give the chunked ones' bits."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    rows = k.shape[1] if over_keys else q.shape[1]
    step = (_DKDV_WIDE_TILE if not over_keys and q.shape[-1] > CHUNK
            else _TILE)
    for r0 in range(0, rows, step):
        tile = slice(r0, r0 + step)
        qs, ks = (slice(None), tile) if over_keys else (tile, slice(None))
        s = _logits(qf[:, qs], kf[:, ks])
        p = torch.exp(s * scale - lse[:, qs, None])
        ds = p * (_logits(gf[:, qs], vf[:, ks]) - delta[:, qs, None])
        yield tile, _two_bf16(p, split), _two_bf16(ds, split)


def attention_fwd_emulation(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, split: bool = True,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) by the arithmetic of the tensor-core forward kernel (for
    the tests; no model calls it): the online softmax over 64-key tiles,
    the running max taken of the exact product of the inputs (bf16 on the
    card) and the scale (times log2 e) applied inside the exponent,
    ``denom`` summed from the float32 p, and p entering ``p @ v`` as bf16
    hi + lo. With ``split=False`` p is rounded to one bf16 value instead.
    ``scale`` (1/sqrt(D) by default) is the one the launch is given: a
    head dim padded with zeros keeps the true one (``_padded``). Past
    D = 128 the logits are summed chunk by chunk (``_logits``), as every
    block of the wide kernel sums them before it takes its 128-wide chunk
    of the output."""
    _check(q, k, v)
    scale = _scale(q.shape[-1]) if scale is None else scale
    scale2 = scale * _LOG2E
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full(q.shape[:2] + (1,), -1e30, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], _TILE):
        tile = slice(k0, k0 + _TILE)
        s = _logits(qf, kf[:, tile])
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale2)
        p = torch.exp2(s * scale2 - m_new * scale2)
        denom = denom * alpha + p.sum(-1, keepdim=True)
        acc *= alpha
        for part in _two_bf16(p, split):
            acc += part @ vf[:, tile]
        m = m_new
    denom = denom.clamp_min(_FLOOR)
    return ((acc * (1.0 / denom)).to(q.dtype),
            (m * scale + torch.log(denom)).squeeze(-1))


def attention_dq_emulation(q, k, v, g, lse, delta, split: bool = True,
                           scale: Optional[float] = None) -> torch.Tensor:
    """dq by the arithmetic of the tensor-core dq kernel (for the tests; no
    model calls it): ds enters ``ds @ k`` as bf16 hi + lo, one product
    each into one float32 sum, and the sum is scaled at the end. With
    ``split=False`` ds is rounded to one bf16 value instead; ``scale`` as
    the forward's emulation takes it. Where the route is the TF32 kernel
    (float32 at a padded ``TF32_HEAD_DIM``, ``_on_tf32``:
    ``attn_dq_wide_tf32_kernel``'s arithmetic) every product is three TF32
    products (``_tf32_product``) over 32-key tiles: S and dP, then
    ``ds @ k``, each in its kernel's order of sums; ``split`` is not read
    there."""
    _check(q, k, v)
    _check_grad(q, g, lse, delta)
    scale = _scale(q.shape[-1]) if scale is None else scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if _on_tf32(q):
        for tile, _, ds in _tf32_tiles(q, k, v, g, lse, delta, True, scale):
            acc = _tf32_product(_tf32_parts(ds),
                                _tf32_parts(k[:, tile].float()), acc)
        return (acc * scale).to(q.dtype)
    for tile, _, ds_parts in _emulated_tiles(q, k, v, g, lse, delta, True,
                                             split, scale):
        for part in ds_parts:
            acc += part @ k[:, tile].float()
    return (acc * scale).to(q.dtype)


def attention_dkdv_emulation(q, k, v, g, lse, delta, split: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) by the arithmetic of the tensor-core dk/dv kernel (for the
    tests; no model calls it): p and ds enter ``p^T @ g`` and ``ds^T @ q``
    as bf16 hi + lo, and dk is scaled at the end; ``scale`` as the
    forward's emulation takes it. Where the route is the TF32 kernel
    (``_on_tf32``: ``attn_dkdv_wide_tf32_kernel``'s arithmetic) every
    product is three TF32 products over 32-query tiles; ``split`` is not
    read there."""
    _check(q, k, v)
    _check_grad(q, g, lse, delta)
    scale = _scale(q.shape[-1]) if scale is None else scale
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    if _on_tf32(q):
        for tile, p, ds in _tf32_tiles(q, k, v, g, lse, delta, False,
                                       scale):
            dv = _tf32_product(_tf32_parts(p.transpose(1, 2)),
                               _tf32_parts(g[:, tile].float()), dv)
            dk = _tf32_product(_tf32_parts(ds.transpose(1, 2)),
                               _tf32_parts(q[:, tile].float()), dk)
        return (dk * scale).to(k.dtype), dv.to(v.dtype)
    for tile, p_parts, ds_parts in _emulated_tiles(q, k, v, g, lse, delta,
                                                   False, split, scale):
        for part in p_parts:
            dv += part.transpose(1, 2) @ g[:, tile].float()
        for part in ds_parts:
            dk += part.transpose(1, 2) @ q[:, tile].float()
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    from boosted_detr_torch.ops import build

    lib = build.load("attention")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for name, pointers in (("attention_fwd", 5), ("attention_dq", 7),
                           ("attention_dkdv", 8), ("attention_dq_tf32", 11),
                           ("attention_dkdv_tf32", 14)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * pointers + tail
        fn.restype = ctypes.c_int
    lib.attention_occupancy.argtypes = ([ctypes.c_int] * 3
                                        + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.attention_occupancy.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def _use_kernel(name: str, q, k, v, *grad) -> bool:
    """False when every tensor lies on the CPU, where the plain version
    checks them. Otherwise checks them for the kernels and returns True;
    raises unless they all lie on one CUDA device and suit the kernels."""
    tensors = (q, k, v) + grad
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                         f"all must be on one CUDA device or all on the CPU")
    _check(q, k, v)
    if grad:
        _check_grad(q, *grad)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernels take contiguous tensors")
    return True


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run D at: the smallest of
    ``SUPPORTED_HEAD_DIMS`` that holds it, else the next multiple of
    ``CHUNK`` (as the TPU kernel pads D to a multiple of 128,
    pallas_attention.py:86)."""
    return next((n for n in SUPPORTED_HEAD_DIMS if n >= d),
                -(-d // CHUNK) * CHUNK)


def _wide_route(d: int) -> str:
    """The bf16 wide kernels' route at head dim ``d`` past ``CHUNK``, after
    padding: ``""`` (resident) up to ``RESIDENT_MAX_HEAD_DIM``, else
    ``"chunked_"``."""
    padded = padded_head_dim(d)
    if padded <= CHUNK:
        raise ValueError(f"head dim {d} runs on the kernels of D <= {CHUNK}")
    return "" if padded <= RESIDENT_MAX_HEAD_DIM else "chunked_"


def wide_forward_kernel(d: int) -> str:
    """The name of the bf16 forward kernel that a launch at head dim ``d``
    past ``CHUNK`` runs: the resident one (wgmma, TMA, q resident, the
    logits once a tile) up to ``RESIDENT_MAX_HEAD_DIM``, the chunked one
    past it."""
    return f"attn_fwd_wide_{_wide_route(d)}mma_kernel"


def wide_gradient_kernels(d: int, dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[str, str]:
    """The names of the dq and dk/dv kernels that a launch at head dim
    ``d`` past ``CHUNK`` runs in ``dtype``: in bf16 the resident kernels
    up to ``RESIDENT_MAX_HEAD_DIM``, the chunked ones past it; in float32
    the TF32 kernels at a padded ``TF32_HEAD_DIM``, the CUDA-core ones at
    every other."""
    route = _wide_route(d)
    if dtype == torch.float32:
        route = "tf32_" if padded_head_dim(d) == TF32_HEAD_DIM else ""
        return f"attn_dq_wide_{route}kernel", f"attn_dkdv_wide_{route}kernel"
    return (f"attn_dq_wide_{route}mma_kernel",
            f"attn_dkdv_wide_{route}mma_kernel")


def _on_tf32(q: torch.Tensor) -> bool:
    """Whether dq and dk/dv of q (as the wrapper pads it) take the TF32
    kernels."""
    return (q.dtype == torch.float32
            and padded_head_dim(q.shape[-1]) == TF32_HEAD_DIM)


def _narrow_padded(d: int) -> int:
    """``padded_head_dim(d)`` for a head dim up to ``CHUNK``; raises past
    it (the wide kernels' dims)."""
    padded = padded_head_dim(d)
    if padded > CHUNK:
        raise ValueError(f"head dim {d} runs on the wide kernels past "
                         f"{CHUNK}")
    return padded


def narrow_forward_kernel(d: int) -> str:
    """The name of the bf16 forward kernel that a launch at head dim ``d``
    up to ``CHUNK`` runs: ``attn_fwd_wgmma_kernel`` (TMA, q resident), in
    blocks of one warpgroup up to D = 64 and of two at 80 and 128, after
    padding."""
    _narrow_padded(d)
    return "attn_fwd_wgmma_kernel"


def narrow_gradient_kernels(d: int, tq: int, tk: int) -> Tuple[str, str]:
    """The names of the bf16 dq and dk/dv kernels that a launch at head
    dim ``d`` up to ``CHUNK``, ``tq`` queries and ``tk`` keys runs: over
    a stream of at most ``SHORT_STREAM`` rows (``tk`` for dq, ``tq`` for
    dk/dv) the ``mma.sync`` kernels (64-row blocks), dq at a padded D of
    32 and dk/dv at 32 and 64; else the ``wgmma`` kernels (TMA, the
    block's 128 rows resident), as at D = 80 and 128."""
    padded = _narrow_padded(d)

    def name(kind, widest, stream):
        short = padded <= widest and stream <= SHORT_STREAM
        return f"attn_{kind}_{'mma' if short else 'wgmma'}_kernel"

    return name("dq", 32, tk), name("dkdv", 64, tq)


def kernel_occupancy(kernel: str, d: int,
                     dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """(blocks an SM, dynamic shared memory in bytes) of the bf16
    ``kernel`` (``"fwd"``, ``"dq"`` or ``"dkdv"``) on the wgmma route at
    head dim ``d`` up to ``CHUNK`` as built (32, 64, 80 and 128; the
    forward in the blocks it launches, of one warpgroup at D <= 64 and of
    two at 80 and 128), or on the wide route that a launch at ``d`` past
    it (a multiple of it) takes; in float32, of the TF32 dq or dk/dv at
    ``TF32_HEAD_DIM`` (the entry refuses any other); from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current
    card."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib = _library()
    rc = lib.attention_occupancy(("fwd", "dq", "dkdv").index(kernel), d,
                                 int(dtype == torch.bfloat16),
                                 ctypes.byref(blocks), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"attention_occupancy({kernel}, {d}): "
                           f"{lib.attention_error_string(rc).decode()}")
    return blocks.value, smem.value


def _padded(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """[BH, T, D] tensors with D padded with zeros to
    ``padded_head_dim(D)``; as they are where D is that. Zero columns add
    nothing to q.k, to the rows' sums of g * out (delta) or to the lse,
    and the padded columns of out, dq, dk and dv come out zero."""
    d = tensors[0].shape[-1]
    padded = padded_head_dim(d)
    if padded == d:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, padded - d))
                 for t in tensors)


def _check_aligned(name: str, q, *tensors):
    # the tensor-core kernels copy 16 bytes at a time
    if ((q.dtype == torch.bfloat16 or _on_tf32(q))
            and any(t.data_ptr() % 16 for t in (q,) + tensors)):
        raise ValueError(f"{name}: the tensor-core kernels copy rows 16 "
                         f"bytes at a time and take q, k, v and g aligned "
                         f"to that")


def _launch(fn: str, q, k, scale: float, *pointers):
    """Launches entry ``fn`` of the library on q's device and current
    stream, with the logits' ``scale``; raises if the launch was
    refused."""
    lib = _library()
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*pointers, bh, tq, k.shape[1], d,
                              int(q.dtype == torch.bfloat16), scale, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.attention_error_string(rc).decode()} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)} "
                           f"{q.dtype})")


def _tf32_scratch(x: torch.Tensor,
                  transposed: int) -> Tuple[torch.Tensor, ...]:
    """Scratch of the TF32 kernels' split operands for two [BH, T, D]
    tensors shaped as ``x``, in the entries' order: the lo of each ([BH,
    T, D]), then for the first ``transposed`` of them the transpose and
    its lo ([BH, D, T8], T8 = T rounded up to 8)."""
    bh, t, d = x.shape
    t8 = -(-t // 8) * 8
    return (torch.empty_like(x), torch.empty_like(x),
            *(torch.empty((bh, d, t8), dtype=x.dtype, device=x.device)
              for _ in range(2 * transposed)))


def _sliced(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the forward kernel through the registered op
    ``boosted_detr::attention_fwd``, which ``torch.export`` keeps in its
    graph; CPU tensors take ``attention_fwd_reference``. Each launch adds
    one to ``attention_fwd.launches``, in an exported program too."""
    return torch.ops.boosted_detr.attention_fwd(q, k, v)


attention_fwd.launches = 0


@torch.library.custom_op("boosted_detr::attention_fwd", mutates_args=())
def _attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The body of ``boosted_detr::attention_fwd``: the checks, the
    padding of D, the alignment test and the launch run here, at call
    time."""
    if not _use_kernel("attention_fwd", q, k, v):
        return attention_fwd_reference(q, k, v)
    d = q.shape[-1]
    qp, kp, vp = _padded(q, k, v)
    _check_aligned("attention_fwd", qp, kp, vp)
    out = torch.empty_like(qp)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("attention_fwd", qp, kp, _scale(d), qp.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), out.data_ptr(), lse.data_ptr())
    attention_fwd.launches += 1
    return _sliced(out, d), lse


@_attention_fwd_op.register_fake
def _attention_fwd_fake(q, k, v):
    """out [BH, Tq, D] in q's dtype and lse [BH, Tq] float32, from the
    (possibly symbolic) sizes alone."""
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def attention_dq(q, k, v, g, lse, delta) -> torch.Tensor:
    """dq of the dq kernel; CPU tensors take ``attention_dq_reference``.
    Each launch adds one to ``attention_dq.launches``."""
    if not _use_kernel("attention_dq", q, k, v, g, lse, delta):
        return attention_dq_reference(q, k, v, g, lse, delta)
    d = q.shape[-1]
    q, k, v, g = _padded(q, k, v, g)
    _check_aligned("attention_dq", q, k, v, g)
    dq = torch.empty_like(q)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    if _on_tf32(q):
        # k's and v's lo, k^T and its lo (csrc/attention.cu, tf32_split)
        scratch = _tf32_scratch(k, 1)
        _launch("attention_dq_tf32", q, k, _scale(d), *pointers,
                *(t.data_ptr() for t in scratch))
    else:
        _launch("attention_dq", q, k, _scale(d), *pointers)
    attention_dq.launches += 1
    return _sliced(dq, d)


attention_dq.launches = 0


def attention_dkdv(q, k, v, g, lse, delta
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the dk/dv kernel; CPU tensors take
    ``attention_dkdv_reference``. Each launch adds one to
    ``attention_dkdv.launches``."""
    if not _use_kernel("attention_dkdv", q, k, v, g, lse, delta):
        return attention_dkdv_reference(q, k, v, g, lse, delta)
    d = q.shape[-1]
    q, k, v, g = _padded(q, k, v, g)
    _check_aligned("attention_dkdv", q, k, v, g)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr())
    if _on_tf32(q):
        # q's and dO's lo, their transposes and those ones' lo
        scratch = _tf32_scratch(q, 2)
        _launch("attention_dkdv_tf32", q, k, _scale(d), *pointers,
                *(t.data_ptr() for t in scratch))
    else:
        _launch("attention_dkdv", q, k, _scale(d), *pointers)
    attention_dkdv.launches += 1
    return _sliced(dk, d), _sliced(dv, d)


attention_dkdv.launches = 0


class FusedAttentionFn(torch.autograd.Function):
    """(out, lse) with the flash-style gradient (pallas_attention.py:290-330):
    the forward saves (q, k, v, out, lse); the backward folds the lse's
    cotangent into delta (``delta - g_lse``: d lse / d logits = p) and runs
    dq and dk/dv. An output nobody used arrives as None and counts as 0."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.set_materialize_grads(False)
        out, lse = attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g: Optional[torch.Tensor],
                 g_lse: Optional[torch.Tensor]):
        q, k, v, out, lse = ctx.saved_tensors
        g = (torch.zeros_like(out) if g is None
             else g.to(out.dtype).contiguous())
        delta = (g.float() * out.float()).sum(-1)
        if g_lse is not None:
            delta = delta - g_lse.float()
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = attention_dq(q, k, v, g, lse, delta)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = attention_dkdv(q, k, v, g, lse, delta)
        return dq, dk, dv


def fused_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(D)) v and the per-row log-sum-exp of the scaled
    logits ([BH, Tq] float32), both differentiable."""
    return FusedAttentionFn.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous())


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over q [BH, Tq, D] and k, v [BH, Tk, D]:
    [BH, Tq, D] in q's dtype."""
    return fused_attention_with_lse(q, k, v)[0]
