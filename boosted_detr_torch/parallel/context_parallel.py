"""Context-parallel attention: the key/value token axis split over a mesh
axis, merged exactly.

Counterpart of boosted_detr_tpu/parallel/context_parallel.py. Each rank
holds the whole q and its shard of k and v, computes attention against its
shard, and the shards merge exactly through the online-softmax identity:
with m the global row max of the shards' maxima (or lse), each shard's
weight is w_s = exp(m_s - m), and

    out = sum_s w_s acc_s / sum_s w_s d_s

(acc_s and d_s the shard's unnormalised P.V and row sum; for the kernel,
whose output is already normalised, acc_s = out_s exp(lse_s - m_s) and
d_s = exp(lse_s - m_s)). JAX takes m by ``all_gather`` and ``max``; here
it is an ``all_reduce(MAX)``, the same value, and a constant of the
backward: the result does not depend on it, so leaving it out of the
gradient is exact.

The gradients: the output is replicated and each rank's loss uses it
whole, so the cotangent reaching the two sums is already the whole one
and is not summed again (``mesh.sum_forward``); q is replicated but each
rank uses it for its shard only, so dq is summed over the axis
(``mesh.sum_backward``); dk and dv stay with their shard.

``impl`` keeps JAX's names: ``"xla"`` is the plain per-shard partial,
``"pallas"`` runs ``ops/attention.py::fused_attention_with_lse`` on each
shard (the K3 kernels on the card, their plain versions on the CPU), whose
lse cotangent folds into the backward's delta.
"""

from __future__ import annotations

import math

import torch

from boosted_detr_torch.parallel import mesh as mesh_lib


def _local_partial(q, k, v, scale):
    """Per-shard partial attention in float32: (acc, max, denom)."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = logits.amax(-1, keepdim=True).detach()
    p = torch.exp(logits - m)
    return p @ v.float(), m, p.sum(-1, keepdim=True)


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mesh: mesh_lib.Mesh,
                               axis: str = mesh_lib.MODEL_AXIS,
                               impl: str = "xla") -> torch.Tensor:
    """Exact attention with the key/value token axis split over ``axis``.

    q: [B, Tq, D], the whole of it on every rank of the axis; k, v:
    [B, Tk / n, D], this rank's shard (the ranks in order along the axis
    hold consecutive shards). Returns [B, Tq, D] in q's dtype, equal to
    plain softmax attention over all keys, on every rank of the axis."""
    found = mesh_lib.axis_of(axis, mesh)
    group = found[2] if found is not None else None
    q = mesh_lib.sum_backward(q, group)
    if impl == "pallas":
        from boosted_detr_torch.ops.attention import fused_attention_with_lse

        out, lse = fused_attention_with_lse(q, k, v)
        m_local = lse[..., None]
        acc = out.float()
        denom = torch.ones_like(m_local)
    elif impl == "xla":
        acc, m_local, denom = _local_partial(q, k, v,
                                             1.0 / math.sqrt(q.shape[-1]))
    else:
        raise ValueError(f"unknown impl '{impl}'")
    m = mesh_lib.all_reduce_max(m_local, group)
    weight = torch.exp(m_local - m)
    acc = mesh_lib.sum_forward(acc * weight, group)
    denom = mesh_lib.sum_forward(denom * weight, group)
    return (acc / denom.clamp_min(1e-30)).to(q.dtype)
