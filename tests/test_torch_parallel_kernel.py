"""Training across processes on the card: two ranks share one CUDA card
over gloo with CUDA tensors (NCCL refuses two ranks on one device), each a
process of its own meeting the other at a ``file://`` store.

- context parallelism: q [4, 128, D] and k, v [4, 256, D] in bf16 at
  D = 32 and at ViT-Huge's D = 80 (which K3 pads to 128), two shards of
  128 keys, through the K3 kernels on each rank (forward, dq,
  dk/dv each launched once a rank), against the one-process
  ``fused_attention_with_lse`` (K3 over all keys) and the plain version.
  Each shard's output is K3's bf16 output, and the merge sums the two, so
  an output value is held to K3's gate (1e-5 / 2**-7) of the magnitude the
  merge summed, sum_s w_s |out_s|, which is |out| where the shards agree in
  sign; the gradients, made of such values, to 2**-7 of their norm;
- data parallelism: the small float32 DETR on two ranks of 4 rows against
  one rank of 8 on the card, at the small models' gates (losses 1e-4
  relative, new parameters 2e-5).

It needs a CUDA card and nvcc, and skips without a card. It imports
nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_kernel.py
"""

import numpy as np
import pytest
import torch

from boosted_detr_torch.ops import attention as ta
from torch_parallel_cases import run_ranks, same_on_every_rank, train_case


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cp_inputs(d):
    rng = np.random.default_rng(0)
    return {x: rng.standard_normal((4, t, d)).astype(np.float32)
            for x, t in (("q", 128), ("k", 256), ("v", 256))}


def _one_process(inputs, cuda, fn):
    q, k, v = (torch.from_numpy(inputs[x]).to(cuda, torch.bfloat16)
               .requires_grad_() for x in "qkv")
    out = fn(q, k, v)
    (out.float() ** 2).sum().backward()
    return {"out": out.detach().float().cpu(), "dq": q.grad.float().cpu(),
            "dk": k.grad.float().cpu(), "dv": v.grad.float().cpu()}


def _shard_magnitude(inputs, cuda):
    """sum_s w_s |out_s| of the merge, from each shard's K3 output."""
    q = torch.from_numpy(inputs["q"]).to(cuda, torch.bfloat16)
    parts = []
    for s in range(2):
        k, v = (torch.from_numpy(inputs[x][:, 128 * s:128 * (s + 1)]).to(
            cuda, torch.bfloat16) for x in "kv")
        parts.append(ta.attention_fwd(q, k, v))
    lse = torch.stack([p[1] for p in parts])
    w = torch.softmax(lse, dim=0)[..., None]
    return sum(w[s] * parts[s][0].float().abs() for s in range(2)).cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 80])
def test_context_parallel_through_k3_on_two_ranks(cuda, tmp_path, d):
    inputs = _cp_inputs(d)
    ranks = run_ranks("context_case", dict(
        inputs, impls=("pallas",), dtype="bfloat16", device="cuda",
        mesh={"data": 1, "model": 2}), 2, tmp_path)
    for r in ranks:
        assert r["launches"] == {"attention_fwd": 1, "attention_dq": 1,
                                 "attention_dkdv": 1}, r["launches"]
    got = {"out": torch.from_numpy(ranks[0]["pallas"]["out"]),
           "dq": torch.from_numpy(ranks[0]["pallas"]["dq"]),
           **{x: torch.from_numpy(np.concatenate(
               [r["pallas"][x] for r in ranks], axis=1))
              for x in ("dk", "dv")}}
    for r in ranks[1:]:
        assert np.array_equal(r["pallas"]["out"], ranks[0]["pallas"]["out"])
        assert np.array_equal(r["pallas"]["dq"], ranks[0]["pallas"]["dq"])
    magnitude = _shard_magnitude(inputs, cuda)
    for want in (_one_process(inputs, cuda, ta.fused_attention),
                 _one_process(inputs, cuda, lambda q, k, v:
                              ta.attention_fwd_reference(q, k, v)[0])):
        err = (got["out"] - want["out"]).abs()
        bound = 1e-5 + 2.0 ** -7 * torch.maximum(magnitude,
                                                 want["out"].abs())
        assert (err <= bound).all(), err.max()
        for x in ("dq", "dk", "dv"):
            rel = ((got[x] - want[x]).norm() / want[x].norm()).item()
            assert rel <= 2.0 ** -7, (x, rel)


_SMALL = dict(num_object_preds=16, image_size=(64, 64), num_encoder_blocks=2,
              num_encoder_heads=2, encoder_dim=32, num_decoder_blocks=2,
              num_decoder_heads=2, decoder_dim=32, num_categories=12,
              num_attributes=8, backbone="tiny", backbone_width=0.25,
              compute_dtype="float32", max_objects=4, dropout_rate=0.1,
              matcher="pallas")


@pytest.mark.gpu
def test_data_parallel_step_on_two_ranks(cuda, tmp_path):
    rng = np.random.default_rng(1)
    batch = {"image": rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32),
             "category_ids": rng.integers(2, 12, (8, 4)).astype(np.int32),
             "attribute_ids": rng.integers(0, 8, (8, 4, 2)).astype(np.int32),
             "bbox": rng.uniform(0.1, 0.4, (8, 4, 4)).astype(np.float32),
             "num_objects": rng.integers(0, 5, (8,)).astype(np.int32)}
    case = dict(model="detr", cfg=_SMALL, seed=3, batch=batch,
                train=dict(batch_size=8), device="cuda")
    got = same_on_every_rank(run_ranks("train_case", case, 2, tmp_path))
    want = train_case(case, None)
    for k, w in want["aux"].items():
        assert abs(got["aux"][k] - w) <= 1e-4 * max(abs(w), 1e-6), k
    for k, w in want["state"].items():
        tol = 1e-4 * np.abs(w).clip(1e-2) if "running" in k else 2e-5
        assert (np.abs(got["state"][k] - w) <= tol).all(), k
