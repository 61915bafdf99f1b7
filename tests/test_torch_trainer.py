"""The port's ``Trainer`` and profiling tools (boosted_detr_torch/train/
trainer.py, train/profiling.py) on the CPU, held against the port's own
steps, which the other tests hold against JAX: ``compile`` and ``fit``
give ``make_train_step``'s steps bit for bit (the Trainer adds nothing to
a step), ``scan_steps`` changes no result, checkpoints restore a run that
goes on bit for bit, and ``train_block``, ``agc_clip`` and the panoptic
model reach the steps they name. Dropout is on (0.1): a step's bits come
from ``(seed, step)``, so equal states give equal steps."""

import csv
import os

import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.data import augment as taug
from boosted_detr_torch.models import panoptic as tpanoptic
from boosted_detr_torch.train import metrics as tmetrics
from boosted_detr_torch.train import profiling
from boosted_detr_torch.train import steps as tsteps

torch.set_num_threads(2)

SMALL = dict(image_size=(32, 32), backbone="resnet", backbone_width=0.01,
             stem="patchify8", use_pallas_stem=True, num_encoder_blocks=1,
             num_decoder_blocks=2, encoder_dim=16, decoder_dim=16,
             num_encoder_heads=2, num_decoder_heads=2, num_object_preds=8,
             num_categories=8, num_attributes=7, max_objects=4,
             compute_dtype="float32", matcher="pallas", dropout_rate=0.1)
B = 4


def _cfg(**kw):
    return bt.ModelConfig(**dict(SMALL, **kw))


def _batches(n, seed=0, masks=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"image": rng.uniform(0, 1, (B, 32, 32, 3)).astype(np.float32),
             "category_ids": rng.integers(2, 8, (B, 4)).astype(np.int32),
             "attribute_ids": rng.integers(0, 7, (B, 4, 3)).astype(np.int32),
             "bbox": rng.uniform(0.05, 0.45, (B, 4, 4)).astype(np.float32),
             "num_objects": rng.integers(1, 5, (B,)).astype(np.int32),
             "image_id": np.arange(B, dtype=np.int64)}
        if masks:
            b["masks"] = tpanoptic.masks_from_boxes(
                torch.from_numpy(b["bbox"]), torch.from_numpy(
                    b["num_objects"]), masks).numpy()
        out.append(b)
    return out


def _trainer(cfg=None, tcfg=None, model_cls=bt.DETR, **model_kw):
    cfg = cfg or _cfg()
    tcfg = tcfg or bt.TrainConfig(batch_size=B)
    model = model_cls(cfg, device="cpu", seed=3, **model_kw)
    return bt.Trainer(model, cfg, tcfg, device="cpu").compile()


def _direct(cfg, tcfg, batches, model_cls=bt.DETR, step_of=None,
            mask=None, **model_kw):
    """The same steps without the Trainer."""
    model = model_cls(cfg, device="cpu", seed=3, **model_kw)
    named = list(model.named_parameters())
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, named, d_model=cfg.decoder_dim,
        trainable_mask=mask(model) if mask else None),
        ema=tcfg.ema_decay > 0)
    step = (step_of or (lambda m: bt.make_train_step(m, cfg, tcfg)))(model)
    losses = []
    for b in batches:
        state, aux = step(state, {k: torch.from_numpy(v) for k, v in b.items()
                                  if k != "image_id"})
        losses.append(float(aux["loss"]))
    return state, losses


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    oa, ob = a.optimizer.inner.state_dict(), b.optimizer.inner.state_dict()
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    if a.ema_params is not None or b.ema_params is not None:
        for k, v in a.ema_params.items():
            assert torch.equal(v, b.ema_params[k]), k


def test_fit_equals_make_train_step_bit_for_bit():
    batches = _batches(3)
    trainer = _trainer()
    history = trainer.fit(batches, epochs=1)
    state, losses = _direct(_cfg(), bt.TrainConfig(batch_size=B), batches)
    _assert_same_state(trainer.state, state)
    assert history["loss"] == [sum(losses) / 3]


def test_scan_steps_change_no_result():
    batches = _batches(3)
    grouped, single = _trainer(), _trainer()
    h2 = grouped.fit(batches, epochs=2, scan_steps=2)  # a group and a tail
    h1 = single.fit(batches, epochs=2, scan_steps=1)
    assert h2 == h1
    _assert_same_state(grouped.state, single.state)


def test_steps_per_epoch_and_validation():
    batches = _batches(3)
    trainer = _trainer()
    h = trainer.fit(lambda: iter(batches), epochs=2, steps_per_epoch=2,
                    validation_batches=batches[:2])
    assert trainer.state.step == 4 and len(h["val_loss"]) == 2
    ev = trainer.evaluate(batches[:2])
    assert ev["loss"] == pytest.approx(h["val_loss"][-1], rel=1e-6)


def test_nan_guard_and_empty_iterables():
    bad = _batches(1)
    bad[0]["image"][0, 0, 0, 0] = np.nan
    trainer = _trainer()
    with pytest.raises(bt.NaNLossError, match="step 1"):
        trainer.fit(bad)
    trainer = _trainer()  # the first's weights are NaN now, as JAX's are
    with pytest.raises(ValueError, match="empty"):
        trainer.fit([])
    with pytest.raises(ValueError, match="CALLABLE"):
        trainer.fit(iter(_batches(1)), epochs=2)  # exhausted in epoch 2


def test_csv_and_tensorboard_logs(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    trainer = _trainer()
    log = tmp_path / "logs" / "train.csv"
    trainer.fit(_batches(3), log_path=str(log),
                tensorboard_dir=str(tmp_path / "tb"), log_every=2)
    with open(log) as f:
        rows = list(csv.DictReader(f))
    # JAX's rule: a row when the step count crosses a multiple of log_every
    assert [int(r["step"]) for r in rows] == [2]
    assert set(rows[0]) >= {"loss", "loss_total", "loss_category", "iou"}
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    events = acc.Scalars("loss")
    assert [e.step for e in events] == [2]
    assert events[0].value == pytest.approx(float(rows[0]["loss"]),
                                            rel=1e-6)


def test_checkpoints_restore_a_run_that_goes_on_bit_for_bit(tmp_path):
    batches = _batches(4)
    tcfg = bt.TrainConfig(batch_size=B, checkpoint_dir=str(tmp_path / "ck"),
                          keep_checkpoints=2, ema_decay=0.9)
    first = _trainer(tcfg=tcfg)
    first.fit(lambda: iter(batches[:1]), epochs=3)
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_2.pt", "ckpt_3.pt"]
    resumed = _trainer(tcfg=tcfg)  # compile restores the latest
    assert resumed.state.step == 3
    _assert_same_state(resumed.state, first.state)
    first.fit(batches[1:2])
    resumed.fit(batches[1:2])
    _assert_same_state(resumed.state, first.state)
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_3.pt", "ckpt_4.pt"]


def test_save_and_load_weights_with_and_without_ema(tmp_path):
    trainer = _trainer(tcfg=bt.TrainConfig(batch_size=B, ema_decay=0.5))
    trainer.fit(_batches(2))
    trainer.save_weights(str(tmp_path / "w.pt"))
    again = _trainer(tcfg=bt.TrainConfig(batch_size=B, ema_decay=0.5))
    again.load_weights(str(tmp_path / "w.pt"))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, again.model.state_dict()[k]), k
    for k, v in trainer.state.ema_params.items():
        assert torch.equal(v, again.state.ema_params[k]), k
    # a file without a shadow re-seeds it from the loaded parameters
    plain = _trainer()
    plain.save_weights(str(tmp_path / "plain.pt"))
    again.load_weights(str(tmp_path / "plain.pt"))
    for k, p in again.model.named_parameters():
        assert torch.equal(again.state.ema_params[k], p)
    plain.load_weights(str(tmp_path / "w.pt"))  # a shadow it cannot hold
    assert plain.state.ema_params is None


BOOSTED = dict(SMALL, num_decoder_blocks=3, dropout_rate=0.0)


def test_train_block_through_the_trainer_is_the_staged_step():
    cfg = bt.ModelConfig(**BOOSTED)
    tcfg = bt.TrainConfig(batch_size=B, train_block=1,
                          use_intermediate_losses=True)
    batches = _batches(2)
    trainer = _trainer(cfg, tcfg, bt.BoostedDETR)
    frozen = {k: v.clone() for k, v in trainer.model.named_parameters()
              if not k.split(".")[0].endswith("_1")
              and k.split(".")[0] != "decoder_prep"}
    trainer.fit(batches)
    state, _ = _direct(cfg, tcfg, batches, bt.BoostedDETR,
                       mask=lambda m: bt.boosted_block_mask(m, 1))
    _assert_same_state(trainer.state, state)
    params = dict(trainer.model.named_parameters())
    assert frozen and all(torch.equal(params[k], v)
                          for k, v in frozen.items())
    # a ready optimizer handed to compile is masked the same way
    model = bt.BoostedDETR(cfg, device="cpu", seed=3)
    ready = bt.Trainer(model, cfg, tcfg, device="cpu").compile(
        optimizer=bt.make_optimizer(tcfg, model.named_parameters()))
    ready.fit(batches)
    _assert_same_state(ready.state, state)


def test_agc_clip_through_the_trainer(monkeypatch):
    """``agc_clip`` needs named parameters; the Trainer passes them, and
    each of its steps runs the clip over every unit."""
    cfg = _cfg(norm="skipinit", dropout_rate=0.0)
    tcfg = bt.TrainConfig(batch_size=B, agc_clip=0.05)
    batches = _batches(2)
    trainer = _trainer(cfg, tcfg)
    units = [p for p, _ in trainer.state.optimizer.agc]
    named = dict(trainer.model.named_parameters())
    assert units == [p for n, p in named.items()
                     if tsteps.unitwise_dims(n, p) is not None]
    clipped = []
    clip = tsteps.adaptive_grad_clip

    def spy(pairs, value):
        clipped.append((len(pairs), value))
        return clip(pairs, value)

    monkeypatch.setattr(tsteps, "adaptive_grad_clip", spy)
    trainer.fit(batches)
    assert clipped == [(len(units), 0.05)] * 2
    state, _ = _direct(cfg, tcfg, batches)
    _assert_same_state(trainer.state, state)
    with pytest.raises(ValueError, match="named_parameters"):
        bt.make_optimizer(tcfg, trainer.model.parameters())


def test_panoptic_models_take_the_panoptic_steps():
    cfg = _cfg(dropout_rate=0.0)
    tcfg = bt.TrainConfig(batch_size=B)
    batches = _batches(2, masks=16)
    trainer = _trainer(cfg, tcfg, bt.DETRPanoptic, mask_size=16)
    trainer.fit(batches)
    state, _ = _direct(
        cfg, tcfg, batches, bt.DETRPanoptic, mask_size=16,
        step_of=lambda m: bt.make_panoptic_train_step(m, tcfg))
    _assert_same_state(trainer.state, state)
    assert "loss_mask" in trainer.evaluate(batches[:1])
    preds = trainer.predict(batches[0]["image"], decode_text=False)
    assert preds["masks"].shape == (B, 8, 16, 16)


def test_predict_evaluate_and_map_through_the_trainer():
    from boosted_detr_torch.data.codec import TextCodec

    codec = TextCodec({"category": [f"c{i}" for i in range(6)],
                       "attribute": [f"a{i}" for i in range(5)]})
    cfg = _cfg()
    tcfg = bt.TrainConfig(batch_size=B, ema_decay=0.5)
    model = bt.DETR(cfg, device="cpu", seed=3)
    trainer = bt.Trainer(model, cfg, tcfg, codec=codec, device="cpu")
    trainer.compile(sample_batch=_batches(1)[0])
    batches = _batches(2)
    trainer.fit(batches)
    image = batches[0]["image"]
    raw = trainer.predict(image, decode_text=False)
    direct = bt.predict(model, image, decode_text=False)
    assert raw.keys() == direct.keys()
    for k, v in direct.items():
        np.testing.assert_array_equal(raw[k], v)
    cats, atts, boxes = trainer.predict(torch.from_numpy(image))
    assert len(cats) == B and boxes.shape == (B, 8, 4)
    served = trainer.export_inference_fn()(image)
    assert (served[0] == cats).all()
    exits = trainer.predict(image, decode_text=False,
                            early_exit_threshold=0.0)
    assert (exits["exit_block"] == 0).all()
    ema = trainer.predict(image, decode_text=False, use_ema=True)
    assert not np.allclose(ema["category"], raw["category"])
    assert trainer.evaluate(batches, use_ema=True)["loss"] != pytest.approx(
        trainer.evaluate(batches)["loss"])
    result = tmetrics.evaluate_map(trainer, batches)
    assert 0.0 <= result["mAP"] <= 1.0


def test_what_the_trainer_refuses(tmp_path):
    cfg = _cfg()
    model = bt.DETR(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        bt.Trainer(model, cfg, bt.TrainConfig(), device="cpu").fit([])
    with pytest.raises(ValueError, match="image"):
        bt.Trainer(model, cfg, bt.TrainConfig(), device="cpu").compile(
            sample_batch={"image": np.zeros((1, 16, 16, 3))})
    # export_serving exports and serves (tests/test_torch_serving.py holds
    # the artifact against JAX's); it refuses a platform it has no program
    # for
    trainer = _trainer()
    path = trainer.export_serving(str(tmp_path / "artifact"),
                                  platforms="cpu")
    image = _batches(1)[0]["image"]
    served = bt.load_serving(path)(image, decode_text=False)
    want = trainer.predict(image, decode_text=False)
    for k, v in want.items():
        np.testing.assert_array_equal(served[k], v, err_msg=k)
    with pytest.raises(ValueError, match="platforms"):
        trainer.export_serving(str(tmp_path / "tpu"), platforms=("cpu",
                                                                 "tpu"))
    with pytest.raises(ValueError, match="mesh shape"):
        _trainer(tcfg=bt.TrainConfig(mesh_shape={"data": 2}))
    with pytest.raises(ValueError, match="lies on"):
        bt.Trainer(model, cfg, bt.TrainConfig(), device="meta")


def test_fit_takes_prefetched_and_augmented_batches():
    """The host route: SyntheticShapes -> Pipeline -> prefetch_to_device
    -> augmentation through ``batch_fn`` -> fit."""
    from boosted_detr_torch.data.codec import TextCodec

    ds = bt.SyntheticShapes(num_images=8, image_size=32, max_objects=4)
    codec = TextCodec(ds.get_vocab())
    pipe = bt.Pipeline((32, 32), 4, codec, dataset=ds)
    df = ds.dataframes("train")
    cfg = _cfg(num_categories=len(codec.category_vocab),
               num_attributes=len(codec.attribute_vocab))
    trainer = _trainer(cfg)
    gen = torch.Generator().manual_seed(0)
    history = trainer.fit(
        lambda: bt.prefetch_to_device(pipe.batches(df, B), device="cpu"),
        epochs=2, batch_fn=lambda b: taug.augment_batch(gen, b))
    assert trainer.state.step == 4 and np.isfinite(history["loss"]).all()


def test_step_meter_compiled_cost_and_debug_nans():
    meter = profiling.StepMeter(batch_size=4, warmup=1, device="cpu")
    for _ in range(4):
        meter.tick()
    summary = meter.summary()
    assert summary["steps_measured"] == 3 and summary["images_per_sec"] > 0
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert profiling.compiled_cost(torch.matmul, a, b) == {
        "flops": 2.0 * 8 * 16 * 4}
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match="nan"):
        with profiling.debug_nans():
            torch.log(x - 1.0).sum() * 0.0
    with profiling.debug_nans():
        y = torch.log(x)  # -inf is not a NaN
    assert torch.isinf(y[0])
    with profiling.debug_nans(False):
        assert torch.isnan(x / x)[0]


def test_trace_writes_a_profile(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))


def test_step_is_unchanged_by_the_trainer_with_a_captured_batch():
    """A step of ``fit`` from the state of a direct step is the direct
    step's, with the batch ``batch_fn`` produced captured."""
    captured = []
    gen = torch.Generator().manual_seed(1)

    def augment(batch):
        out = taug.augment_batch(gen, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        captured.append(out)
        return out

    trainer = _trainer()
    trainer.fit(_batches(1), batch_fn=augment)
    batch = {k: v.numpy() for k, v in captured[0].items()}
    state, _ = _direct(_cfg(), bt.TrainConfig(batch_size=B), [batch])
    _assert_same_state(trainer.state, state)
