"""Patchify-stem convolution: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of boosted_detr_tpu/ops/pallas_patchify.py: ``patchify_conv``
(:209-231) with the forward Pallas kernel ``_fwd_kernel``/``_fwd_impl``
(:83-92, :122-149). The kernel, ``csrc/patchify.cu``, is CUDA C++ for
``sm_90a``, built by nvcc at first use and loaded with ctypes
(``ops/build.py``). One thread block takes one output row (b, ho) and a
slice of up to 128 output channels: it stages its P contiguous image rows
in shared memory (clipped to [0, 1] and rounded to the weights' dtype),
stages the [P*P*C_in, slice] kernel beside them, and accumulates every
output of the row in float32 by FMA. Space-to-depth is only an offset into
the staged rows, so the image is read from device memory once.

Bound on an H100 SXM at the flagship shape (x f32 [8, 640, 640, 3], w bf16
[8, 8, 3, 128], out bf16 [8, 80, 80, 128]): 39.3 MB read plus 13.1 MB
written is about 15.7 us at 3.35 TB/s, against about 2.5 us for its 2.52
GFLOP at 989 TFLOP/s, so memory bytes bound it. This first version reads
each byte once but multiplies on the CUDA cores; the tensor cores (wgmma)
and TMA are the later steps toward the bound. Shared memory grows with P,
W and C_in; the wrapper narrows the channel slice until a block fits in
227 KB and raises with the geometry when none does.

Where P does not divide H or W, the JAX package takes an ordinary
SAME-padded convolution instead of its kernel (``supported``, :47-50). Here
the kernel (and the plain version) compute that same SAME-padded result
directly, with the padding as zeros, so one path serves every geometry.

The weight gradient (``_dw_kernel``) is not ported yet: this is the
inference slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
    reshape/permute, float32 matmul of the rounded values, cast."""
    out_dtype = out_dtype or w.dtype
    _check(x, w, out_dtype)
    b, h, width, c_in = x.shape
    p, c_out = w.shape[0], w.shape[3]
    if clip01:
        x = x.clamp(0.0, 1.0)
    x = x.to(w.dtype)
    (top, bottom), (left, right) = (same_padding(h, p, p),
                                    same_padding(width, p, p))
    if top or bottom or left or right:
        x = torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))
    ho, wo = x.shape[1] // p, x.shape[2] // p
    patches = x.reshape(b, ho, p, wo, p, c_in).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b * ho * wo, p * p * c_in)
    out = patches.float() @ w.reshape(p * p * c_in, c_out).float()
    return out.reshape(b, ho, wo, c_out).to(out_dtype)


# The most shared memory one thread block may use on an H100 (227 KB).
SMEM_LIMIT = 232448


def _library() -> ctypes.CDLL:
    from boosted_detr_torch.ops import build

    lib = build.load("patchify")
    lib.patchify_fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
                                 + [ctypes.c_void_p])
    lib.patchify_fwd.restype = ctypes.c_int
    lib.patchify_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.patchify_smem_bytes.restype = ctypes.c_longlong
    lib.patchify_error_string.argtypes = [ctypes.c_int]
    lib.patchify_error_string.restype = ctypes.c_char_p
    return lib


def _channel_slice(lib, p: int, c_in: int, wo: int, c_out: int,
                   w_bf16: bool) -> Tuple[int, int]:
    """(channels per block, shared memory bytes): all of ``c_out`` up to
    128, halved while the block's image rows and kernel slice exceed
    ``SMEM_LIMIT``. Raises with the geometry when not even 4 channels fit."""
    bn = 4
    while bn < min(c_out, 128):
        bn *= 2
    while True:
        smem = lib.patchify_smem_bytes(p, c_in, wo, bn, int(w_bf16))
        if smem <= SMEM_LIMIT:
            return bn, smem
        if bn == 4:
            raise ValueError(
                f"patchify_conv: a block needs {smem} bytes of shared memory "
                f"for P={p}, C_in={c_in}, Wo={wo} ({p} image rows of "
                f"{wo * p * c_in} values) even at 4 channels, over the "
                f"{SMEM_LIMIT}-byte limit")
        bn //= 2


def patchify_conv(x: torch.Tensor, w: torch.Tensor, *,
                  out_dtype: Optional[torch.dtype] = None,
                  clip01: bool = False) -> torch.Tensor:
    """Non-overlapping (stride == kernel) SAME conv of ``x`` [B,H,W,C_in]
    float32 with ``w`` [P,P,C_in,C_out] -> [B,ceil(H/P),ceil(W/P),C_out] in
    ``out_dtype`` (default ``w.dtype``). ``clip01`` clamps the image to
    [0, 1] inside the kernel's read.

    A CPU tensor goes to ``patchify_conv_reference``. A CUDA tensor launches
    the kernel or raises; there is no fallback. Each launch adds one to
    ``patchify_conv.launches``."""
    out_dtype = out_dtype or w.dtype
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
    bn, _ = _channel_slice(lib, p, c_in, wo, c_out, w_bf16)
    # whole float4 loads of the image rows need rows with no horizontal
    # padding, a multiple of 4 values long, from a 16-byte aligned base
    vec4 = (left == 0 and wo * p == width and (width * c_in) % 4 == 0
            and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.patchify_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, width, c_in, p,
            c_out, ho, wo, top, left, bn, int(w_bf16),
            int(out_dtype == torch.bfloat16), int(clip01), int(vec4), stream)
    if rc != 0:
        raise RuntimeError(
            f"patchify_fwd launch failed: "
            f"{lib.patchify_error_string(rc).decode()} (x {tuple(x.shape)}, "
            f"w {tuple(w.shape)} {w.dtype}, out {out_dtype}, {bn} channels "
            f"per block)")
    patchify_conv.launches += 1
    return out


patchify_conv.launches = 0
