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
D = 80, 32 at 128). bfloat16 inputs run on the tensor cores: the forward,
dq and dk/dv up to D = 64 on ``mma.sync`` with bf16 operands and float32
sums, a block's 64 rows in registers, the other operand streamed in
64-row tiles two deep with ``cp.async`` (16 bytes at a time, so q, k, v
and g must be aligned to that or the wrapper raises; the TMA kernels need
the same); the forward, dq and dk/dv at D = 80 and 128 on ``wgmma`` and
TMA (``attn_fwd_wgmma_kernel``, ``attn_dq_wgmma_kernel``,
``attn_dkdv_wgmma_kernel``: two warpgroups of 64 rows, the block's rows
resident, the streamed tiles in a ring of stages, p and ds from
registers as the A operand of the second products, the sums in the
``mma.sync`` kernels' order; ``narrow_forward_kernel`` and
``narrow_gradient_kernels`` name the route up to 128); the wide forward
at D = 256 and 384 on ``wgmma`` as above. The exact bf16 q.k product is
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
    the forward's emulation takes it."""
    _check(q, k, v)
    _check_grad(q, g, lse, delta)
    scale = _scale(q.shape[-1]) if scale is None else scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
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
    forward's emulation takes it."""
    _check(q, k, v)
    _check_grad(q, g, lse, delta)
    scale = _scale(q.shape[-1]) if scale is None else scale
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
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
                           ("attention_dkdv", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * pointers + tail
        fn.restype = ctypes.c_int
    for name, ints in (("attention_wide_occupancy", 2),
                       ("attention_fwd_wgmma_occupancy", 1)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_int] * ints
                       + [ctypes.POINTER(ctypes.c_int)] * 2)
        fn.restype = ctypes.c_int
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


def wide_gradient_kernels(d: int) -> Tuple[str, str]:
    """The names of the bf16 dq and dk/dv kernels that a launch at head dim
    ``d`` past ``CHUNK`` runs: the resident kernels up to
    ``RESIDENT_MAX_HEAD_DIM``, the chunked ones past it."""
    route = _wide_route(d)
    return (f"attn_dq_wide_{route}mma_kernel",
            f"attn_dkdv_wide_{route}mma_kernel")


def _narrow_route(d: int) -> str:
    """The bf16 kernels' route at head dim ``d`` up to ``CHUNK``, after
    padding: ``"mma"`` (``mma.sync``) up to D = 64, ``"wgmma"`` (TMA, the
    block's rows resident) at D = 80 and 128."""
    padded = padded_head_dim(d)
    if padded > CHUNK:
        raise ValueError(f"head dim {d} runs on the wide kernels past "
                         f"{CHUNK}")
    return "wgmma" if padded > 64 else "mma"


def narrow_forward_kernel(d: int) -> str:
    """The name of the bf16 forward kernel that a launch at head dim ``d``
    up to ``CHUNK`` runs: ``attn_fwd_mma_kernel`` up to D = 64,
    ``attn_fwd_wgmma_kernel`` at D = 80 and 128, after padding."""
    return f"attn_fwd_{_narrow_route(d)}_kernel"


def narrow_gradient_kernels(d: int) -> Tuple[str, str]:
    """The names of the bf16 dq and dk/dv kernels that a launch at head
    dim ``d`` up to ``CHUNK`` runs: the ``mma.sync`` kernels up to D = 64,
    the ``wgmma`` kernels (TMA, the block's rows resident) at D = 80 and
    128, after padding."""
    route = _narrow_route(d)
    return f"attn_dq_{route}_kernel", f"attn_dkdv_{route}_kernel"


def _occupancy(entry: str, *args: int) -> Tuple[int, int]:
    """(blocks an SM, dynamic shared memory in bytes) from the library's
    occupancy entry ``entry`` called with ``args``."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib = _library()
    rc = getattr(lib, entry)(*args, ctypes.byref(blocks), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"{entry}{args}: "
                           f"{lib.attention_error_string(rc).decode()}")
    return blocks.value, smem.value


def wide_occupancy(kernel: str, d: int) -> Tuple[int, int]:
    """(blocks an SM, dynamic shared memory in bytes) of the bf16 wide
    ``kernel`` (``"fwd"``, ``"dq"`` or ``"dkdv"``) that a launch at head dim
    ``d`` (a multiple of ``CHUNK`` past it) takes, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current
    card."""
    return _occupancy("attention_wide_occupancy",
                      ("fwd", "dq", "dkdv").index(kernel), d)


def narrow_forward_occupancy(d: int) -> Tuple[int, int]:
    """The same for the bf16 forward at D = 80 and 128
    (``attn_fwd_wgmma_kernel``)."""
    return _occupancy("attention_fwd_wgmma_occupancy", d)


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
    if (q.dtype == torch.bfloat16
            and any(t.data_ptr() % 16 for t in (q,) + tensors)):
        raise ValueError(f"{name}: the bfloat16 kernels copy rows 16 bytes "
                         f"at a time and take q, k, v and g aligned to that")


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
    _launch("attention_dq", q, k, _scale(d), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr())
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
    _launch("attention_dkdv", q, k, _scale(d), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
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
