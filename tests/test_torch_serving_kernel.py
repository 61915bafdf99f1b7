"""The serving artifact on the card (boosted_detr_torch/serving.py): the
forward kernels as registered ops (``boosted_detr::patchify_fwd`` and
``boosted_detr::attention_fwd``) against their wrappers bit for bit, with
their launches counted; small bf16 models exported for ``cuda``, whose
loaded programs equal the live models bit for bit and count one launch of
each op a forward; and, in a process of its own (a profiler once attached
stays attached in its process), the loaded artifacts' device kernels by
name: ``patchify_fwd_mma_kernel`` and the bf16 forward at D = 32 that
``narrow_forward_kernel`` names (``attn_fwd_wgmma_kernel``). It needs a
CUDA card and nvcc, skips without a card, and imports nothing of JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_serving_kernel.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch import serving
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.ops import attention as ta
from boosted_detr_torch.ops import patchify as tp

ROOT = Path(__file__).resolve().parents[1]
VOCAB = {"category": [f"c{i}" for i in range(10)],
         "attribute": [f"a{i}" for i in range(18)]}
# bf16 models whose stem takes the tensor-core K1 (P=8, 3 -> 32 channels)
# and whose attentions take the tensor-core K3 (D=32)
SMALL = dict(image_size=(64, 64), num_encoder_blocks=2, num_decoder_blocks=2,
             encoder_dim=64, decoder_dim=64, num_encoder_heads=2,
             num_decoder_heads=2, num_object_preds=16, num_categories=12,
             num_attributes=20, max_objects=8, compute_dtype="bfloat16",
             dropout_rate=0.0, use_pallas_stem=True, norm="batchnorm")
MODELS = {
    "resnet": dict(SMALL, backbone="resnet", backbone_width=0.25,
                   stem="patchify8"),
    "vit": dict(SMALL, backbone="vit_p16_d2_w64_h2",
                use_pallas_attention=True),
}
# launches of each op a forward: the stem; the ViT blocks, the encoder
# blocks, the cross-attentions and the decoder self-attentions after the
# first block
PER_FORWARD = {"resnet": (1, 0), "vit": (1, 2 + 2 + 2 + 1)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return tp.patchify_conv.launches, ta.attention_fwd.launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_registered_ops_equal_their_wrappers(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((2, 64, 64, 3), generator=gen, device=cuda)
    w = torch.randn((8, 8, 3, 32), generator=gen, device=cuda).to(dtype)
    before = _launches()
    got = torch.ops.boosted_detr.patchify_fwd(x, w, dtype, True)
    want = tp.patchify_conv(x, w, clip01=True)
    assert torch.equal(got, want)
    q, k, v = (torch.randn((4, t, 32), generator=gen, device=cuda).to(dtype)
               for t in (96, 200, 200))
    out, lse = torch.ops.boosted_detr.attention_fwd(q, k, v)
    want_out, want_lse = ta.attention_fwd(q, k, v)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert _launches() == (before[0] + 2, before[1] + 2)


def _export(kind, path, device="cuda"):
    cfg = bt.ModelConfig(**MODELS[kind])
    model = bt.DETR(cfg, device=device, seed=1)
    trainer = bt.Trainer(model, cfg, bt.TrainConfig(),
                         codec=TextCodec(VOCAB), device=device).compile()
    serving.export_serving(trainer, str(path), platforms=device)
    return model


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(MODELS))
def test_cuda_artifact_equals_the_live_model(cuda, kind, tmp_path):
    model = _export(kind, tmp_path)
    served = serving.load_serving(str(tmp_path))
    assert served.meta["platforms"] == ["cuda"]
    ops = [str(n.target) for n in served.program.graph.nodes
           if str(n.target).startswith("boosted_detr.")]
    assert ops.count("boosted_detr.patchify_fwd.default") == 1
    assert ops.count("boosted_detr.attention_fwd.default") == PER_FORWARD[
        kind][1]
    images = np.random.default_rng(2).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    want = bt.predict(model, images, decode_text=False)
    before = _launches()
    got = served(images, decode_text=False)
    torch.cuda.synchronize()
    after = _launches()
    assert (after[0] - before[0], after[1] - before[1]) == PER_FORWARD[kind]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


_PROFILE = """
import json, sys
import numpy as np
import torch
from boosted_detr_torch import serving
served = serving.load_serving(sys.argv[1])
images = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(
    np.float32)
served(images)  # built and loaded before the profile
activities = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=activities) as prof:
    served(images, decode_text=False)
    torch.cuda.synchronize()
print(json.dumps(sorted({e.key for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and ("patchify" in e.key or "attn_" in e.key)})))
"""


@pytest.mark.gpu
def test_loaded_artifacts_run_the_tensor_core_kernels(cuda, tmp_path):
    names = {}
    for kind in MODELS:
        _export(kind, tmp_path / kind)
        out = subprocess.run(
            [sys.executable, "-c", _PROFILE, str(tmp_path / kind)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        assert out.returncode == 0, out.stderr
        names[kind] = json.loads(out.stdout.strip().splitlines()[-1])
    assert any("patchify_fwd_mma_kernel" in n for n in names["resnet"]), names
    assert not any("attn_" in n for n in names["resnet"]), names
    assert any("patchify_fwd_mma_kernel" in n for n in names["vit"]), names
    # 16 patches and 16 object queries, D = 32
    assert any(ta.narrow_forward_kernel(32) in n
               for n in names["vit"]), names
