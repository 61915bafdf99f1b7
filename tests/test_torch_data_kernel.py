"""The training loop's device side on the card (boosted_detr_torch/data/
device_synth.py, data/augment.py, data/pipeline.py::prefetch_to_device,
train/trainer.py) against the CPU: ``rasterize`` bit for bit, the pure
augmentations with the same draws within 1e-6, the prefetched batches bit
for bit, and a ``Trainer`` on the card. It needs a CUDA card and skips
without one. It imports nothing of JAX, so that it runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_data_kernel.py
"""

import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.data import augment
from boosted_detr_torch.data import device_synth

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(seed, batch=4, slots=32, size=640):
    gen = torch.Generator().manual_seed(seed)
    scenes = [device_synth.sample_scene(gen, 8, 2, (0.04, 0.6), slots)
              for _ in range(batch)]
    scene = {k: torch.stack([s[k] for s in scenes]) for k in scenes[0]}
    bg = torch.stack([device_synth.draw_background(gen, size)
                      for _ in range(batch)])
    return scene, bg


def test_rasterize_on_the_card_is_the_cpus_bit_for_bit(cuda):
    scene, bg = _scene(0)
    want = device_synth.rasterize(bg, scene, 640)
    got = device_synth.rasterize(bg.to(cuda), {k: v.to(cuda) for k, v in
                                               scene.items()}, 640)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    for a, b in zip(device_synth.scene_labels(
            {k: v.to(cuda) for k, v in scene.items()}),
            device_synth.scene_labels(scene)):
        assert torch.equal(a.cpu(), b)


def test_augmentations_on_the_card_match_the_cpu(cuda):
    rng = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(rng.uniform(
        0, 1, (8, 640, 640, 3)).astype(np.float32)),
        "bbox": torch.from_numpy(rng.uniform(
            0.05, 0.45, (8, 32, 4)).astype(np.float32)),
        "masks": torch.from_numpy((rng.uniform(
            0, 1, (8, 32, 96, 96)) > 0.5).astype(np.float32))}
    batch["bbox"][:, 20:] = -10.0
    draws = augment.draw_augmentations(torch.Generator().manual_seed(2), 8)
    want = augment.apply_augmentations(batch, draws)
    got = augment.apply_augmentations(
        {k: v.to(cuda) for k, v in batch.items()},
        {k: v.to(cuda) for k, v in draws.items()})
    for k in ("image", "bbox", "masks"):
        err = (got[k].cpu() - want[k]).abs().max().item()
        assert err <= 1e-6, (k, err)
    fresh = augment.augment_batch(torch.Generator(device=cuda).manual_seed(0),
                                  {k: v.to(cuda) for k, v in batch.items()})
    assert fresh["image"].is_cuda and 0 <= fresh["image"].min() <= 1


def test_prefetch_to_the_card_yields_the_iterators_batches(cuda):
    rng = np.random.default_rng(3)
    items = [{"image": rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32),
              "num_objects": rng.integers(0, 9, 8).astype(np.int32),
              "path": np.asarray(["a"] * 8)} for _ in range(5)]
    got = list(bt.prefetch_to_device(iter(items), size=2, device=cuda))
    assert len(got) == 5
    for g, w in zip(got, items):
        assert g["image"].is_cuda and g["num_objects"].is_cuda
        assert torch.equal(g["image"].cpu(), torch.from_numpy(w["image"]))
        assert torch.equal(g["num_objects"].cpu(),
                           torch.from_numpy(w["num_objects"]))
        assert g["path"] is w["path"]


def test_batch_fn_renders_on_the_card(cuda):
    batch = bt.make_batch_fn(64, 4, 8, pool_size=None, device=cuda)(0)
    assert all(v.is_cuda for v in batch.values())
    assert batch["image"].shape == (4, 64, 64, 3)
    again = bt.make_batch_fn(64, 4, 8, pool_size=None, device=cuda)(0)
    assert torch.equal(batch["image"], again["image"])


def test_trainer_on_the_card_matches_the_cpu(cuda):
    """One ``fit`` step of a small float32 DETR on the card against the
    same on the CPU: the loss within 1e-4 relative (the kernels and cuDNN
    sum in other orders than the CPU)."""
    cfg = bt.ModelConfig(image_size=(64, 64), backbone="resnet",
                         backbone_width=0.25, stem="patchify8",
                         use_pallas_stem=True, num_encoder_blocks=1,
                         num_decoder_blocks=2, encoder_dim=32,
                         decoder_dim=32, num_object_preds=16,
                         num_categories=12, num_attributes=20, max_objects=8,
                         compute_dtype="float32", matcher="pallas",
                         dropout_rate=0.0)
    rng = np.random.default_rng(4)
    batch = {"image": rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32),
             "category_ids": rng.integers(2, 12, (4, 8)).astype(np.int32),
             "attribute_ids": rng.integers(0, 20, (4, 8, 3)).astype(np.int32),
             "bbox": rng.uniform(0.05, 0.45, (4, 8, 4)).astype(np.float32),
             "num_objects": rng.integers(1, 9, (4,)).astype(np.int32)}
    tcfg = bt.TrainConfig(batch_size=4, freeze_bn_stats=True)
    weights = bt.DETR(cfg, device="cpu", seed=1).state_dict()
    losses = {}
    for dev in ("cpu", cuda):
        model = bt.DETR(cfg, device=dev)
        model.load_state_dict(weights)
        trainer = bt.Trainer(model, cfg, tcfg, device=dev).compile()
        losses[str(dev)] = trainer.fit([batch])["loss"][0]
    cpu, card = losses["cpu"], losses[str(cuda)]
    assert abs(card - cpu) <= 1e-4 * abs(cpu), losses
