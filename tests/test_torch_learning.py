"""End-to-end learning with the port's training loop (slow; not in
tier-1): ``SyntheticShapes`` -> ``Pipeline`` -> ``Trainer.fit`` until the
model detects, the analogue of tests/test_integration_learning.py's
overfit test, on the CPU. It proves that the matcher, the loss, the loop,
the decode and the evaluation compose."""

import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.train import metrics


@pytest.mark.slow
def test_overfit_synthetic_reaches_map():
    torch.set_num_threads(4)
    ds = bt.SyntheticShapes(num_images=16, image_size=64, max_objects=3,
                            seed=0)
    df = ds.dataframes("train")
    codec = TextCodec(ds.get_vocab())
    cfg = bt.ModelConfig(
        num_object_preds=12, image_size=(64, 64), num_encoder_blocks=2,
        num_encoder_heads=4, encoder_dim=64, num_decoder_blocks=2,
        num_decoder_heads=4, decoder_dim=64, backbone="tiny",
        backbone_width=1.0, compute_dtype="float32", max_objects=4,
        dropout_rate=0.0, num_categories=len(codec.category_vocab),
        num_attributes=len(codec.attribute_vocab))
    tcfg = bt.TrainConfig(optimizer="adamw", learning_rate=1e-3,
                          lr_schedule="constant", clipnorm=0.0)
    pipe = bt.Pipeline((64, 64), 4, codec, dataset=ds)
    trainer = bt.Trainer(bt.DETR(cfg, device="cpu"), cfg, tcfg,
                         codec=codec, device="cpu").compile()
    history = trainer.fit(lambda: pipe.batches(df, batch_size=8, seed=0),
                          epochs=400)
    assert history["loss"][-1] < 0.05 * history["loss"][0]
    result = metrics.evaluate_map(
        trainer, pipe.batches(df, batch_size=8, shuffle=False))
    assert result["mAP50"] > 0.3, result
    sample = next(pipe.batches(df, batch_size=8, shuffle=False))
    cats, _, _ = trainer.predict(sample["image"][:4])
    assert (np.asarray(cats) != "<PAD>").sum() > 0
