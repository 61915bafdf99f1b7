"""Patchify-stem convolution: the hand-written Hopper kernels and their
plain PyTorch versions.

Counterpart of boosted_detr_tpu/ops/pallas_patchify.py: ``patchify_conv``
(:209-231) with the forward Pallas kernel ``_fwd_kernel``/``_fwd_impl``
(:83-92, :122-149). The kernels, ``csrc/patchify.cu``, are CUDA C++ for
``sm_90a``, built by nvcc at first use and loaded with ctypes
(``ops/build.py``). The forward has two:

- ``patchify_fwd_mma_kernel`` takes bfloat16 weights on the tensor cores
  (``mma.sync`` on bf16 operands, float32 sums) where the patch divides the
  image, ``P * C_in`` is a multiple of 8, k of 16 and ``C_out`` of 8: the
  three shapes the models run (P = 8 -> 128 at 640 and 1280 px, P = 16 ->
  384). A block takes up to 80 output positions and all channels (up to
  384), so the image is read from device memory once; k = (di, dj, c) runs
  in slabs of 48 values whose image rows and weight rows stream through
  shared memory two deep with ``cp.async``; one pass clips the rows, rounds
  them to bf16 and lays them out by position (the space-to-depth), and
  ``ldmatrix`` feeds the MMAs from there. ``tensor_core_plan`` decides the
  route and the cut from the shapes alone.
- ``patchify_fwd_kernel``, the first version, keeps everything else
  (float32 weights, the P = 4 stem, SAME-padded geometries, misaligned
  tensors): one block an output row and a slice of up to 128 channels, the
  P image rows staged as float32 beside the kernel slice, FMA on the CUDA
  cores; ``fwd_span_plan`` narrows the slice until a block fits in 227 KB
  and, where P whole rows do not fit even at 4 channels (P = 16 at
  W = 4096), gives a block a span of the row's positions instead.

Bound on an H100 SXM at the flagship shape (x f32 [8, 640, 640, 3], w bf16
[8, 8, 3, 128], out bf16 [8, 80, 80, 128]): 39.3 MB read plus 13.1 MB
written is about 15.7 us at 3.35 TB/s, against about 2.5 us for its 2.52
GFLOP at 989 TFLOP/s, so memory bytes bound it (at P = 16 -> 384 too: 49.7
MB, 14.8 us, against 7.6 us). bf16 x bf16 products are exact in float32, so
the tensor-core kernel differs from the plain version by the order of the
float32 sums only: one bf16 ulp where a sum straddles a rounding boundary.
On the geometries that kernel takes, the plain version sums as it does
(``mma_step_sums``: each 16-wide MMA step summed exactly and rounded toward
zero, as the tensor cores' additions truncate, the steps added in k order
in float32): at the 640 stem that leaves 3 of 6,553,600 bf16 outputs on
another value than the kernel's, against 383 for one float32 matmul
(probes/k1_sum_order.py, H100 80GB HBM3 at 700 W).

Where P does not divide H or W, the JAX package takes an ordinary
SAME-padded convolution instead of its kernel (``supported``, :47-50). Here
the CUDA-core kernel (and the plain version) compute that same SAME-padded
result directly, with the padding as zeros, so the wrapper serves every
geometry.

The weight gradient (``_dw_kernel``/``_dw_impl``, :95-113, :152-175) is
``patchify_conv_dw``: the reduction over the M output positions, which the
TPU carries across its sequential grid, runs in two deterministic passes
(per-chunk float32 partials, then a sum over the chunks in a fixed order).
Its bound at the flagship shape is 39.3 MB of image and 13.1 MB of g read,
about 15.6 us at 3.35 TB/s, against about 2.5 us of tensor-core work:
memory bytes bound it too. It has two kernels as the forward does:
``patchify_dw_mma_kernel`` takes bf16 weights and g on the tensor cores
where ``dw_tensor_core_plan`` gives a plan (the forward's conditions; any
width: a block owns a [192 x 128] tile of dw in registers over a chunk of
80-position stages that stream two deep, image rows and g through
``cp.async``); ``patchify_dw_emulation`` is its order of sums in plain
torch, for the tests. ``patchify_dw_partial_kernel`` keeps float32
weights, the P = 4 stem and SAME-padded geometries, at any width: it
stages a span of a row's positions at a time (``dw_span_plan``), the
whole row where it fits, the same sums in the same order on every cut.
``PatchifyConvFn`` is the custom VJP (:178-206): forward through
``patchify_conv``, dW through ``patchify_conv_dw``, and dx in plain torch
(depth-to-space of g times the kernel, zeroed where the clip cut) only when
the image needs a gradient.

The forward is the registered op ``boosted_detr::patchify_fwd``
(``torch.library.custom_op``): ``torch.export`` keeps it in the exported
program as one node (serving.py), whose body picks the route and launches
at call time, and its fake gives the output's shape from symbolic sizes.
The weight gradient is not exported and stays a plain wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

_DTYPES = (torch.float32, torch.bfloat16)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding (lo, hi) of one spatial axis.

    Trap: SAME is asymmetric. It pads ``total // 2`` before and the rest
    after, so a stride-2 3x3 conv on an even input pads 0 before and 1
    after, where torch's ``padding=1`` would pad 1 on both sides."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _check(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"patchify_conv: x must be [B,H,W,C_in] and w "
                         f"[P,P,C_in,C_out], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.shape[0] != w.shape[1]:
        raise ValueError(f"patchify kernels are square, got {tuple(w.shape)}")
    if x.shape[-1] != w.shape[2]:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"patchify_conv reads a float32 image, got {x.dtype}")
    if w.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"weights and output must be float32 or bfloat16, "
                        f"got {w.dtype} and {out_dtype}")


def patchify_conv_reference(x: torch.Tensor, w: torch.Tensor, *,
                            out_dtype: Optional[torch.dtype] = None,
                            clip01: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with the same arithmetic:
    clip, round to ``w.dtype``, SAME zero padding, space-to-depth by
    reshape/permute, the float32 sum of the rounded values' products,
    cast. Where the tensor-core kernel takes the geometry
    (``tensor_core_plan``) the sum is taken in its order
    (``mma_step_sums``); elsewhere it is one float32 matmul."""
    out_dtype = out_dtype or w.dtype
    _check(x, w, out_dtype)
    p, c_out = w.shape[0], w.shape[3]
    patches, (b, ho, wo) = _patch_matrix(x, p, w.dtype, clip01)
    w2 = w.reshape(-1, c_out)
    if tensor_core_plan(tuple(x.shape), tuple(w.shape), w.dtype) is None:
        out = patches.float() @ w2.float()
    else:
        out = mma_step_sums(patches, w2)
    return out.reshape(b, ho, wo, c_out).to(out_dtype)


MMA_K = 16  # k values of one mma.sync.m16n8k16 step


def mma_step_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` ([M, K] x [K, N] bf16, K a multiple of 16) summed as
    ``patchify_fwd_mma_kernel`` sums it: each MMA step's 16 products from
    zero, exactly (in float64, where bf16 products and their sums of 16
    are exact) and rounded toward zero to float32, as the tensor cores'
    additions truncate; then the steps added in k order, float32 rounded
    to nearest. Float32 [M, N]."""
    a64, b64 = a.double(), b.double()
    acc = None
    for s in range(0, a.shape[1], MMA_K):
        exact = a64[:, s:s + MMA_K] @ b64[s:s + MMA_K]
        part = exact.float()
        over = part.double().abs() > exact.abs()  # rounded away from zero
        part = torch.where(over, torch.nextafter(part, torch.zeros_like(
            part)), part)
        acc = part if acc is None else acc + part
    return acc


def _patch_matrix(x: torch.Tensor, p: int, dtype: torch.dtype, clip01: bool):
    """[M, P*P*C_in] patches of ``x`` in ``dtype``, rows in (b, ho, wo)
    order, columns in (di, dj, c) order: clip, round, SAME zero padding,
    space-to-depth by reshape/permute. Returns (patches, (B, Ho, Wo))."""
    b, h, width, c_in = x.shape
    if clip01:
        x = x.clamp(0.0, 1.0)
    x = x.to(dtype)
    (top, bottom), (left, right) = (same_padding(h, p, p),
                                    same_padding(width, p, p))
    if top or bottom or left or right:
        x = torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))
    ho, wo = x.shape[1] // p, x.shape[2] // p
    patches = x.reshape(b, ho, p, wo, p, c_in).permute(0, 1, 3, 2, 4, 5)
    return patches.reshape(b * ho * wo, p * p * c_in), (b, ho, wo)


def _check_dw(x: torch.Tensor, g: torch.Tensor, patch: int,
              w_dtype: torch.dtype):
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"patchify_conv_dw: x must be [B,H,W,C_in] and g "
                         f"[B,Ho,Wo,C_out], got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    b, h, width, _ = x.shape
    want = (b, -(-h // patch), -(-width // patch))
    if tuple(g.shape[:3]) != want:
        raise ValueError(f"patchify_conv_dw: g {tuple(g.shape)} does not fit "
                         f"x {tuple(x.shape)} at P={patch}")
    if x.dtype != torch.float32:
        raise TypeError(f"patchify_conv_dw reads a float32 image, got "
                        f"{x.dtype}")
    if w_dtype not in _DTYPES or g.dtype not in _DTYPES:
        raise TypeError(f"weights and g must be float32 or bfloat16, got "
                        f"{w_dtype} and {g.dtype}")


def patchify_conv_dw_reference(x: torch.Tensor, g: torch.Tensor, patch: int,
                               w_dtype: torch.dtype, *, clip01: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the weight gradient, with the kernel's
    arithmetic: patches and g rounded to ``w_dtype``, their product summed
    in float32. Returns (dw [P,P,C_in,C_out] in ``w_dtype``, the same in
    float32 before the rounding)."""
    _check_dw(x, g, patch, w_dtype)
    patches, _ = _patch_matrix(x, patch, w_dtype, clip01)
    c_out = g.shape[-1]
    gm = g.reshape(-1, c_out).to(w_dtype).float()
    dw32 = (patches.float().t() @ gm).reshape(patch, patch, x.shape[-1],
                                              c_out)
    return dw32.to(w_dtype), dw32


# The most shared memory one thread block may use on an H100 (227 KB).
SMEM_LIMIT = 232448


# The C entry points of csrc/patchify.cu: (argument types, result type).
_SIGNATURES = {
    "patchify_fwd": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 16
                     + [ctypes.c_void_p], ctypes.c_int),
    "patchify_fwd_mma": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
                         + [ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int),
    "patchify_smem_bytes": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "patchify_dw": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 17
                    + [ctypes.c_void_p], ctypes.c_int),
    "patchify_dw_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_longlong),
    "patchify_dw_mma": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                        + [ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int),
    "patchify_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


@functools.cache
def _library() -> ctypes.CDLL:
    from boosted_detr_torch.ops import build

    lib = build.load("patchify")
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


# A block of the forward cut into spans takes the widest channel slice
# that leaves room for this many positions (or the whole row).
MIN_SPAN = 32


class SpanPlan(NamedTuple):
    """How a CUDA-core kernel cuts a row of ``wo`` output positions: a
    block stages ``span`` positions at a time (``wo``: the whole row) for
    ``channels`` output channels (the forward's slice; the weight
    gradient's 128-channel tile), in ``smem`` bytes of shared memory."""
    channels: int
    span: int
    smem: int


def fwd_smem_bytes(p: int, c_in: int, span: int, bn: int,
                   w_bf16: bool) -> int:
    """``patchify_smem_bytes``: P image rows of ``span`` positions as
    float32, rounded up to 16 bytes, then the [P*P*C_in, bn] kernel
    slice."""
    image = (p * span * p * c_in * 4 + 15) // 16 * 16
    return image + p * p * c_in * bn * (2 if w_bf16 else 4)


def dw_smem_bytes(p: int, c_in: int, span: int) -> int:
    """``dw_smem``: the image rows a 64-value k tile touches and the g row
    (128 channels), both float32, over ``span`` positions."""
    pc = p * c_in
    rows = min((DW_TILE_K - 1) // pc + 2, p)
    image = -(-rows * span * pc // 4) * 4
    return 4 * image + 4 * span * DW_TILE_N


def _longest_span(wo: int, fits) -> int:
    """The most positions up to ``wo`` for which ``fits`` holds, cut into
    equal spans; 0 where not even one fits."""
    lo, hi = 0, wo
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo and -(-wo // -(-wo // lo))


def fwd_span_plan(p: int, c_in: int, wo: int, c_out: int,
                  w_bf16: bool) -> SpanPlan:
    """The CUDA-core forward's cut: whole rows with all of ``c_out`` up to
    128 channels a block, the slice halved down to 4 while a block passes
    ``SMEM_LIMIT``; where not even 4 channels fit beside P whole rows, the
    widest slice whose block holds ``MIN_SPAN`` positions (or the row), at
    the longest span that fits. Raises with the geometry when not one
    position fits."""
    top = 4
    while top < min(c_out, 128):
        top *= 2
    bn = top
    while bn >= 4:
        smem = fwd_smem_bytes(p, c_in, wo, bn, w_bf16)
        if smem <= SMEM_LIMIT:
            return SpanPlan(bn, wo, smem)
        bn //= 2
    bn = top
    while True:
        span = _longest_span(wo, lambda n: fwd_smem_bytes(
            p, c_in, n, bn, w_bf16) <= SMEM_LIMIT)
        if span >= min(wo, MIN_SPAN) or (bn == 4 and span):
            return SpanPlan(bn, span,
                            fwd_smem_bytes(p, c_in, span, bn, w_bf16))
        if bn == 4:
            raise ValueError(
                f"patchify_conv: one position needs "
                f"{fwd_smem_bytes(p, c_in, 1, 4, w_bf16)} bytes of shared "
                f"memory for P={p}, C_in={c_in} at 4 channels, over the "
                f"{SMEM_LIMIT}-byte limit")
        bn //= 2


def dw_span_plan(p: int, c_in: int, wo: int) -> SpanPlan:
    """The CUDA-core weight gradient's cut: the whole row where its staged
    rows fit, else the longest span that does. Raises with the geometry
    when not one position fits."""
    span = _longest_span(wo, lambda n: dw_smem_bytes(p, c_in, n)
                         <= SMEM_LIMIT)
    if not span:
        raise ValueError(
            f"patchify_conv_dw: one position needs "
            f"{dw_smem_bytes(p, c_in, 1)} bytes of shared memory for "
            f"P={p}, C_in={c_in}, over the {SMEM_LIMIT}-byte limit")
    return SpanPlan(DW_TILE_N, span, dw_smem_bytes(p, c_in, span))


# The tensor-core forward takes k = (di, dj, c) in slabs of 6 chunks of 8
# values. Each of a block's 8 warps takes 2 blocks of 8 channels (up to 128
# channels a block) or 6 (up to 384). A block takes at most 80 output
# positions (5 tiles of 16) at 2 and 48 (3 tiles) at 6: a warp's
# accumulators for 5 tiles of 48 channels would leave one block on an SM
# where 3 tiles leave two, which measured faster at P=16 -> 384.
MMA_SLAB_CHUNKS = 6
MMA_POSITIONS = {2: 80, 6: 48}


class TensorCorePlan(NamedTuple):
    """How ``patchify_fwd_mma_kernel`` cuts the work: a block takes ``rows``
    output rows (b, ho) by ``seg`` positions wo, in ``tiles`` (3 or 5)
    tiles of 16 positions, and 64 * ``channel_blocks`` channels (2 or 6
    blocks of 8 for each of its 8 warps); ``smem`` bytes of shared memory."""
    rows: int
    seg: int
    tiles: int
    channel_blocks: int
    smem: int


def _slab_rows(p: int, c_in: int) -> int:
    """The most image rows that the chunks of one slab lie in."""
    per_row = p * c_in // 8
    chunks = p * per_row
    return max((min(lo + MMA_SLAB_CHUNKS, chunks) - 1) // per_row
               - lo // per_row + 1
               for lo in range(0, chunks, MMA_SLAB_CHUNKS))


@functools.lru_cache(maxsize=64)
def tensor_core_plan(x_shape, w_shape, w_dtype: torch.dtype
                     ) -> Optional[TensorCorePlan]:
    """The tensor-core forward's plan for this geometry, or None where the
    CUDA-core kernel takes it: float32 weights (the tensor cores would make
    them TF32), a patch that does not divide the image (SAME padding), a
    patch row ``P * C_in`` that is no multiple of 8 values (an 8-value
    chunk of k would straddle two image rows), k or channel counts that
    are no multiples of 16 and 8, or a block over the shared-memory limit.
    A pure function of the shapes: alignment is the wrapper's to check."""
    batch, h, width, c_in = x_shape
    p, c_out = w_shape[0], w_shape[3]
    pc = p * c_in
    if (w_dtype != torch.bfloat16 or h % p or width % p or pc % 8
            or (p * pc) % 16 or c_out % 8 or 0 in (batch, h, width)):
        return None
    ho, wo = h // p, width // p
    channel_blocks = 2 if c_out <= 128 else 6
    positions = MMA_POSITIONS[channel_blocks]
    if wo > positions:
        rows, seg = 1, -(-wo // -(-wo // positions))
    else:
        rows, seg = max(1, min(positions // wo, batch * ho)), wo
    tiles = 3 if rows * seg <= 48 else 5
    smem = (4 * rows * _slab_rows(p, c_in) * seg * pc
            + 2 * 16 * tiles * (8 * MMA_SLAB_CHUNKS + 8)
            + 2 * 2 * 8 * MMA_SLAB_CHUNKS * (64 * channel_blocks + 8)
            + 2 * 4 * 16 * tiles)
    if rows * seg > 16 * tiles or smem > SMEM_LIMIT:
        return None
    return TensorCorePlan(rows, seg, tiles, channel_blocks, smem)


def patchify_conv(x: torch.Tensor, w: torch.Tensor, *,
                  out_dtype: Optional[torch.dtype] = None,
                  clip01: bool = False) -> torch.Tensor:
    """Non-overlapping (stride == kernel) SAME conv of ``x`` [B,H,W,C_in]
    float32 with ``w`` [P,P,C_in,C_out] -> [B,ceil(H/P),ceil(W/P),C_out] in
    ``out_dtype`` (default ``w.dtype``). ``clip01`` clamps the image to
    [0, 1] inside the kernel's read.

    Calls the registered op ``boosted_detr::patchify_fwd``, so that
    ``torch.export`` keeps the call in its graph. Its body, run on real
    tensors at call time, takes ``patchify_conv_reference`` for CPU tensors
    and launches a kernel for CUDA tensors (the tensor-core one where
    ``tensor_core_plan`` gives a plan and x and w are aligned to 16 bytes)
    or raises; there is no fallback. Each launch adds one to
    ``patchify_conv.launches``, in an exported program too."""
    out_dtype = out_dtype or w.dtype
    _check(x, w, out_dtype)
    return torch.ops.boosted_detr.patchify_fwd(x, w, out_dtype, clip01)


patchify_conv.launches = 0


@torch.library.custom_op("boosted_detr::patchify_fwd", mutates_args=())
def _patchify_fwd_op(x: torch.Tensor, w: torch.Tensor,
                     out_dtype: torch.dtype, clip01: bool) -> torch.Tensor:
    """The body of ``boosted_detr::patchify_fwd``: everything that reads a
    concrete shape or a pointer (the plan, the alignment, the route) runs
    here, at call time."""
    _check(x, w, out_dtype)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return patchify_conv_reference(x, w, out_dtype=out_dtype,
                                       clip01=clip01)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"patchify_conv: x on {x.device} and w on "
                         f"{w.device}; both must be on one CUDA device or "
                         f"both on the CPU")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("patchify_conv: x and w must be contiguous")
    b, h, width, c_in = x.shape
    p, c_out = w.shape[0], w.shape[3]
    top, _ = same_padding(h, p, p)
    left, _ = same_padding(width, p, p)
    ho, wo = -(-h // p), -(-width // p)
    out = torch.empty((b, ho, wo, c_out), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    w_bf16 = w.dtype == torch.bfloat16
    lib = _library()
    # the tensor-core kernel copies 16 bytes at a time
    plan = (tensor_core_plan(tuple(x.shape), tuple(w.shape), w.dtype)
            if x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan is not None:
            how = plan
            rc = lib.patchify_fwd_mma(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, width,
                c_in, p, c_out, ho, wo, plan.rows, plan.seg, plan.tiles,
                plan.channel_blocks, int(out_dtype == torch.bfloat16),
                int(clip01), plan.smem, stream)
        else:
            cut = fwd_span_plan(p, c_in, wo, c_out, w_bf16)
            how = (f"the CUDA-core kernel, {cut.channels} channels and "
                   f"{cut.span} positions per block")
            rc = lib.patchify_fwd(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, width,
                c_in, p, c_out, ho, wo, top, left, cut.channels, cut.span,
                int(w_bf16), int(out_dtype == torch.bfloat16), int(clip01),
                int(_vec4(x, p, cut.span)), stream)
    if rc != 0:
        raise RuntimeError(
            f"patchify_fwd launch failed: "
            f"{lib.patchify_error_string(rc).decode()} (x {tuple(x.shape)}, "
            f"w {tuple(w.shape)} {w.dtype}, out {out_dtype}; {how})")
    patchify_conv.launches += 1
    return out


@_patchify_fwd_op.register_fake
def _patchify_fwd_fake(x, w, out_dtype, clip01):
    """The output's shape from the (possibly symbolic) sizes alone."""
    p = w.shape[0]
    return x.new_empty((x.shape[0], (x.shape[1] + p - 1) // p,
                        (x.shape[2] + p - 1) // p, w.shape[3]),
                       dtype=out_dtype)


# Blocks the weight gradient's first pass aims for: two per SM of an H100.
DW_TARGET_BLOCKS = 2 * 132
# The first pass's block tile: 64 k values (di, dj, c) by 128 channels.
DW_TILE_K, DW_TILE_N = 64, 128


def _vec4(x: torch.Tensor, p: int, span: int) -> bool:
    """Whole float4 loads of the image rows need rows with no horizontal
    padding, a multiple of 4 values long, from a 16-byte aligned base, and
    spans of a multiple of 4 values."""
    width, c_in = x.shape[2], x.shape[3]
    left, _ = same_padding(width, p, p)
    wo = -(-width // p)
    return (left == 0 and wo * p == width and (width * c_in) % 4 == 0
            and (span * p * c_in) % 4 == 0 and x.data_ptr() % 16 == 0)


# The tensor-core weight gradient (``patchify_dw_mma_kernel``): a block of
# 8 warps owns a [192 x 128] tile of dw in registers across a chunk of
# stages of up to 80 positions. One block fits on an SM (its 96
# accumulators a lane and 199 KB of shared memory at the main shapes), and
# the plan aims for one block on each of the H100's 132 SMs.
DW_MMA_TILE_K, DW_MMA_TILE_N, DW_MMA_STAGE = 192, 128, 80
DW_MMA_BLOCKS = 132


class DwTensorCorePlan(NamedTuple):
    """How ``patchify_dw_mma_kernel`` cuts the work: stages of ``rows``
    output rows (b, ho) by ``seg`` positions wo, in position order; chunk c
    takes stages ``c * per_chunk`` on, ``chunks`` of them for each
    [192 x 128] tile of dw; ``smem`` bytes of shared memory a block."""
    rows: int
    seg: int
    chunks: int
    per_chunk: int
    smem: int

    def stages(self, total_rows: int, wo: int) -> int:
        return -(-total_rows // self.rows) * -(-wo // self.seg)

    def span(self, st: int, total_rows: int, wo: int) -> Tuple[int, int]:
        """Stage ``st``'s positions: a run [lo, hi) of the (b, ho, wo)
        order of the ``total_rows`` output rows of ``wo`` positions."""
        rg, sg = divmod(st, -(-wo // self.seg))
        row0, wo0 = rg * self.rows, sg * self.seg
        if self.rows > 1:  # whole rows
            return row0 * wo, min(row0 + self.rows, total_rows) * wo
        return row0 * wo + wo0, row0 * wo + min(wo0 + self.seg, wo)


def _dw_tile_rows(p: int, c_in: int) -> int:
    """The most image rows that the k values of one dw tile lie in."""
    pc, k = p * c_in, p * p * c_in
    return max((min(lo + DW_MMA_TILE_K, k) - 1) // pc - lo // pc + 1
               for lo in range(0, k, DW_MMA_TILE_K))


@functools.lru_cache(maxsize=64)
def dw_tensor_core_plan(x_shape, g_shape, patch: int, w_dtype: torch.dtype
                        ) -> Optional[DwTensorCorePlan]:
    """The tensor-core weight gradient's plan for this geometry, or None
    where the CUDA-core kernel takes it: float32 weights (the tensor cores
    would make the products TF32), a patch that does not divide the image
    (SAME padding), ``P * C_in`` no multiple of 8, k or channel counts no
    multiples of 16 and 8, or a block over the shared-memory limit. Any
    width is planned: a long row is cut into segments. A pure function of
    the shapes: g's dtype and alignment are the wrapper's to check."""
    batch, h, width, c_in = x_shape
    c_out = g_shape[3]
    p = patch
    pc = p * c_in
    if (w_dtype != torch.bfloat16 or h % p or width % p or pc % 8
            or (p * pc) % 16 or c_out % 8 or 0 in (batch, h, width, c_out)):
        return None
    ho, wo = h // p, width // p
    if wo > DW_MMA_STAGE:
        rows, seg = 1, -(-wo // -(-wo // DW_MMA_STAGE))
    else:
        rows, seg = max(1, min(DW_MMA_STAGE // wo, batch * ho)), wo
    smem = (2 * 4 * rows * _dw_tile_rows(p, c_in) * seg * pc
            + 2 * DW_MMA_STAGE * (DW_MMA_TILE_K + 8)
            + 2 * 2 * DW_MMA_STAGE * (DW_MMA_TILE_N + 8)
            + 4 * 2 * DW_MMA_STAGE + 4 * (DW_MMA_TILE_K // 8))
    if smem > SMEM_LIMIT:
        return None
    tiles = -(-p * pc // DW_MMA_TILE_K) * -(-c_out // DW_MMA_TILE_N)
    stages = -(-batch * ho // rows) * -(-wo // seg)
    per_chunk = -(-stages // max(1, min(stages, DW_MMA_BLOCKS // tiles)))
    return DwTensorCorePlan(rows, seg, -(-stages // per_chunk), per_chunk,
                            smem)


def patchify_dw_emulation(x: torch.Tensor, g: torch.Tensor, patch: int,
                          w_dtype: torch.dtype, *, clip01: bool = False,
                          plan: Optional[DwTensorCorePlan] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core weight gradient's arithmetic in plain torch, for the
    tests: each chunk's float32 partial summed in the kernel's order of
    16-position MMA steps (a step's 16 exact products summed in float32),
    then the partials summed in chunk order from zero, and the cast.
    ``plan`` defaults to the kernel's. Returns (dw, dw32) as
    ``patchify_conv_dw`` does."""
    _check_dw(x, g, patch, w_dtype)
    plan = plan or dw_tensor_core_plan(tuple(x.shape), tuple(g.shape),
                                       patch, w_dtype)
    if plan is None:
        raise ValueError(f"patchify_dw_emulation: no tensor-core plan for x "
                         f"{tuple(x.shape)}, g {tuple(g.shape)}, P={patch}, "
                         f"{w_dtype}")
    patches, (b, ho, wo) = _patch_matrix(x, patch, w_dtype, clip01)
    a = patches.float()
    c_out = g.shape[-1]
    gm = g.reshape(-1, c_out).to(w_dtype).float()
    total = b * ho
    stages = plan.stages(total, wo)
    dw32 = torch.zeros((a.shape[1], c_out), dtype=torch.float32,
                       device=x.device)
    for c in range(plan.chunks):
        acc = torch.zeros_like(dw32)
        for st in range(c * plan.per_chunk,
                        min((c + 1) * plan.per_chunk, stages)):
            lo, hi = plan.span(st, total, wo)
            for t in range(lo, hi, 16):
                e = min(t + 16, hi)
                acc = acc + a[t:e].t() @ gm[t:e]
        dw32 = dw32 + acc
    dw32 = dw32.reshape(patch, patch, x.shape[-1], c_out)
    return dw32.to(w_dtype), dw32


def patchify_conv_dw(x: torch.Tensor, g: torch.Tensor, patch: int,
                     w_dtype: torch.dtype, *, clip01: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight gradient of ``patchify_conv(x, w, clip01=clip01)`` for the
    output cotangent ``g`` [B,Ho,Wo,C_out]: (dw [P,P,C_in,C_out] in
    ``w_dtype``, its float32 sum before the rounding).

    A CPU tensor goes to ``patchify_conv_dw_reference``. A CUDA tensor
    launches a kernel (the tensor-core one where ``dw_tensor_core_plan``
    gives a plan, g is bf16 and x and g are aligned to 16 bytes; else the
    CUDA-core one) or raises; there is no fallback. Each call that
    launches adds one to ``patchify_conv_dw.launches``."""
    _check_dw(x, g, patch, w_dtype)
    if x.device.type == "cpu" and g.device.type == "cpu":
        return patchify_conv_dw_reference(x, g, patch, w_dtype,
                                          clip01=clip01)
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"patchify_conv_dw: x on {x.device} and g on "
                         f"{g.device}; both must be on one CUDA device or "
                         f"both on the CPU")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("patchify_conv_dw: x and g must be contiguous")
    b, h, width, c_in = x.shape
    ho, wo, c_out = g.shape[1], g.shape[2], g.shape[3]
    top, _ = same_padding(h, patch, patch)
    left, _ = same_padding(width, patch, patch)
    k = patch * patch * c_in
    dw32 = torch.empty((k, c_out), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, c_out), dtype=w_dtype, device=x.device)
    shape = (patch, patch, c_in, c_out)
    if b * ho * wo == 0:
        return dw.zero_().reshape(shape), dw32.zero_().reshape(shape)
    lib = _library()
    # the tensor-core kernel takes g as it is (bf16) and copies 16 bytes at
    # a time
    plan = (dw_tensor_core_plan(tuple(x.shape), tuple(g.shape), patch,
                                w_dtype)
            if g.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
            and g.data_ptr() % 16 == 0 else None)
    if plan is not None:
        partial = torch.empty((plan.chunks, k, c_out),
                              dtype=torch.float32, device=x.device)
        how = plan
        with torch.cuda.device(x.device):
            rc = lib.patchify_dw_mma(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw32.data_ptr(), dw.data_ptr(), b, h, width, c_in, patch,
                c_out, ho, wo, plan.rows, plan.seg, plan.chunks,
                plan.per_chunk, int(clip01), plan.smem,
                torch.cuda.current_stream().cuda_stream)
    else:
        cut = dw_span_plan(patch, c_in, wo)
        tiles = -(-k // DW_TILE_K) * -(-c_out // DW_TILE_N)
        rows = b * ho
        rows_per_chunk = -(-rows // max(1, min(rows, -(-DW_TARGET_BLOCKS
                                                         // tiles))))
        chunks = -(-rows // rows_per_chunk)
        partial = torch.empty((chunks, k, c_out), dtype=torch.float32,
                              device=x.device)
        how = (f"the CUDA-core kernel, {chunks} chunks of {rows_per_chunk} "
               f"rows, {cut.span} positions at a time")
        with torch.cuda.device(x.device):
            rc = lib.patchify_dw(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                dw32.data_ptr(), dw.data_ptr(), b, h, width, c_in, patch,
                c_out, ho, wo, top, left, rows_per_chunk, chunks, cut.span,
                int(w_dtype == torch.bfloat16),
                int(g.dtype == torch.bfloat16), int(clip01),
                int(_vec4(x, patch, cut.span)),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"patchify_dw launch failed: "
            f"{lib.patchify_error_string(rc).decode()} (x {tuple(x.shape)}, "
            f"g {tuple(g.shape)} {g.dtype}, w {w_dtype}; {how})")
    patchify_conv_dw.launches += 1
    return dw.reshape(shape), dw32.reshape(shape)


patchify_conv_dw.launches = 0


def _dx_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
              clip01: bool) -> torch.Tensor:
    """The image's gradient: depth-to-space of g times the kernel in
    float32, cropped to the image, zeroed where the clip cut
    (pallas_patchify.py:193-203)."""
    p, _, c_in, c_out = w.shape
    b, ho, wo, _ = g.shape
    dx = torch.einsum("bhwo,ko->bhwk", g.float(),
                      w.reshape(-1, c_out).float())
    dx = dx.reshape(b, ho, wo, p, p, c_in).permute(0, 1, 3, 2, 4, 5)
    dx = dx.reshape(b, ho * p, wo * p, c_in)
    h, width = x.shape[1], x.shape[2]
    top, _ = same_padding(h, p, p)
    left, _ = same_padding(width, p, p)
    dx = dx[:, top:top + h, left:left + width]
    if clip01:
        dx = torch.where((x >= 0.0) & (x <= 1.0), dx, torch.zeros_like(dx))
    return dx.to(x.dtype)


class PatchifyConvFn(torch.autograd.Function):
    """``patchify_conv`` with its gradient: forward by the kernel (or the
    plain version on the CPU), dW by the weight-gradient kernel (or its
    plain version), dx in plain torch only when the image needs one."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, clip01):
        ctx.save_for_backward(x, w)
        ctx.clip01 = clip01
        return patchify_conv(x, w, out_dtype=out_dtype, clip01=clip01)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw, _ = patchify_conv_dw(x, g.contiguous(), w.shape[0], w.dtype,
                                     clip01=ctx.clip01)
        if ctx.needs_input_grad[0]:
            dx = _dx_plain(x, w, g, ctx.clip01)
        return dx, dw, None, None
