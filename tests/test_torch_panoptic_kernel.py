"""The panoptic model, the classifier pre-trainer and the matchers that
are not kernels (boosted_detr_torch/models/{panoptic,pretrainer}.py,
ops/matching.py) on the card: small float32 models through the K1 and K2
kernels against the same weights on the CPU, and the auction, the greedy
matcher and scipy's on CUDA tensors against the CPU and K2. It needs a
CUDA card and nvcc, and skips without a card. It imports nothing of JAX,
so that it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_panoptic_kernel.py
"""

import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models.panoptic import masks_from_boxes
from boosted_detr_torch.ops import lap
from boosted_detr_torch.ops import matching
from boosted_detr_torch.ops import patchify

torch.set_num_threads(2)

SMALL = dict(image_size=(64, 64), backbone="resnet", backbone_width=0.25,
             stem="patchify8", use_pallas_stem=True, compute_dtype="float32",
             num_encoder_blocks=2, num_decoder_blocks=2, encoder_dim=64,
             decoder_dim=64, num_object_preds=16, num_categories=12,
             num_attributes=20, max_objects=8, matcher="pallas",
             dropout_rate=0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(make):
    cpu = make(device="cpu").eval()
    gpu = make(device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _images():
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -0.05, 1.05, (2, 64, 64, 3)).astype(np.float32))


@pytest.mark.gpu
def test_panoptic_forward_on_the_card_matches_the_cpu(cuda):
    cfg = bt.ModelConfig(**SMALL)
    cpu, gpu = _pair(lambda device: bt.DETRPanoptic(cfg, mask_size=32,
                                                    device=device))
    before = patchify.patchify_conv.launches
    with torch.inference_mode():
        want = cpu(_images(), return_intermediate=True)
        got = gpu(_images().to(cuda), return_intermediate=True)
    assert patchify.patchify_conv.launches == before + 1
    for g, w in zip(got, want):
        assert g["masks"].shape == (2, 16, 32, 32)
        for key in w:  # float32: other orders of sums, ~1e-6
            torch.testing.assert_close(g[key].cpu(), w[key], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.gpu
def test_panoptic_train_step_launches_k1_and_k2(cuda):
    cfg = bt.ModelConfig(**SMALL)
    model = bt.DETRPanoptic(cfg, mask_size=32)
    tcfg = bt.TrainConfig(batch_size=4)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.parameters(), d_model=64))
    rng = np.random.default_rng(1)
    bbox = torch.from_numpy(rng.uniform(0.05, 0.45, (4, 8, 4)).astype(
        np.float32)).to(cuda)
    n = torch.tensor([0, 3, 5, 8], device=cuda)
    batch = {"image": torch.rand((4, 64, 64, 3), device=cuda),
             "category_ids": torch.randint(2, 12, (4, 8), device=cuda),
             "attribute_ids": torch.randint(0, 20, (4, 8, 2), device=cuda),
             "bbox": bbox, "num_objects": n,
             "masks": masks_from_boxes(bbox, n, 32)}
    counts = (patchify.patchify_conv.launches,
              patchify.patchify_conv_dw.launches, lap.hungarian_lap.launches)
    state, aux = bt.make_panoptic_train_step(model, tcfg)(state, batch)
    torch.cuda.synchronize()
    assert (patchify.patchify_conv.launches,
            patchify.patchify_conv_dw.launches,
            lap.hungarian_lap.launches) == tuple(c + 1 for c in counts)
    assert torch.isfinite(aux["loss"]) and aux["loss_mask"].item() > 0


@pytest.mark.gpu
def test_pretrainer_forward_on_the_card_matches_the_cpu(cuda):
    cfg = bt.ModelConfig(**SMALL)
    cpu, gpu = _pair(lambda device: bt.DETRMultiClassifier(
        cfg, cfg.num_categories, device=device))
    with torch.inference_mode():
        want = cpu(_images(), return_intermediate=True)
        got = gpu(_images().to(cuda), return_intermediate=True)
    for g, w in zip(got, want):
        assert g.shape == (2, 1, 12)
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,o,p", [(8, 32, 96), (8, 32, 300), (3, 5, 9)])
def test_matchers_on_cuda_tensors(cuda, b, o, p):
    """The same masks as on the CPU (the same float32 operations), on the
    cost's device; scipy's is K2's mask on tie-free costs."""
    rng = np.random.default_rng(o * p)
    cost = torch.from_numpy(rng.uniform(0, 10, (b, o, p)).astype(np.float32))
    n = torch.from_numpy(rng.integers(0, o + 1, (b,)).astype(np.int32))
    gc, gn = cost.to(cuda), n.to(cuda)
    for name, fn in (("auction", matching.auction_lap),
                     ("greedy", matching.greedy_lap)):
        got = fn(gc, gn)
        assert got.device.type == "cuda", name
        torch.testing.assert_close(got.cpu(), fn(cost, n), atol=0, rtol=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    shuffled = matching.greedy_lap(gc, gn, gen).cpu()
    for i, ni in enumerate(n.tolist()):
        assert (shuffled[i, :ni].sum(1) == 1).all()
        assert (shuffled[i, ni:] == 0).all()
        assert (shuffled[i].sum(0) <= 1).all()
    host = matching.hungarian_host(gc, gn)
    assert host.device.type == "cuda"
    torch.testing.assert_close(host, lap.hungarian_lap(gc, gn), atol=0,
                               rtol=0)
