"""The port's copies of the numpy-only host modules
(boosted_detr_torch/data/masks.py, boosted_detr_torch/train/metrics.py)
against the originals in the JAX package, on the same inputs: polygon
scanline fill, uncompressed and compressed COCO RLE, ``resize_mask``,
``segmentation_to_mask``, ``box_to_mask``; COCO mAP with crowds and area
ranges, the DETR eval records, the attribute metrics, ``evaluate_map_fn``
and ``evaluate_map`` (through a stub trainer: the port has no Trainer
yet), the panoptic canvas, DETR's panoptic segments, Panoptic Quality and
``evaluate_pq``. Both sides are numpy, so results must be equal."""

import numpy as np
import pytest

from boosted_detr_torch.data import masks as tmasks
from boosted_detr_torch.train import metrics as tmet
from boosted_detr_tpu.data import masks as jmasks
from boosted_detr_tpu.train import metrics as jmet


def _rle_counts(mask):
    """Column-major run lengths of a binary mask, starting with a 0 run."""
    counts, run, val = [], 0, 0
    for v in mask.T.reshape(-1):
        if int(v) == val:
            run += 1
        else:
            counts.append(run)
            run, val = 1, int(v)
    counts.append(run)
    return counts


def _compress(counts):
    """COCO's ASCII encoding of run lengths (the inverse of the decode)."""
    s = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)
                        or x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def _segmentations():
    rng = np.random.default_rng(0)
    target = (rng.uniform(size=(23, 17)) > 0.6).astype(np.float32)
    counts = _rle_counts(target)
    ring = [0.1, 0.1, 0.8, 0.2, 0.6, 0.9, 0.2, 0.7]
    star = [0.5, 0.0, 0.6, 0.4, 1.0, 0.4, 0.7, 0.6, 0.8, 1.0, 0.5, 0.75,
            0.2, 1.0, 0.3, 0.6, 0.0, 0.4, 0.4, 0.4]
    return {"polygon": [ring], "two rings": [ring, star],
            "degenerate ring": [[0.1, 0.1, 0.5, 0.5]],
            "rle": {"size": list(target.shape), "counts": counts},
            "compressed rle": {"size": list(target.shape),
                               "counts": _compress(counts)},
            "compressed rle bytes": {"size": list(target.shape),
                                     "counts": _compress(counts).encode()},
            "none": None}


@pytest.mark.parametrize("name", list(_segmentations()))
@pytest.mark.parametrize("size", [16, 33])
def test_segmentation_to_mask_is_the_original(name, size):
    seg = _segmentations()[name]
    box = [0.2, 0.3, 0.5, 0.4]
    for bbox in (box, None):
        got = tmasks.segmentation_to_mask(seg, size, bbox)
        want = jmasks.segmentation_to_mask(seg, size, bbox)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if name.endswith("rle") or name.endswith("bytes"):
        np.testing.assert_array_equal(tmasks.decode_rle(seg),
                                      jmasks.decode_rle(seg))


def test_mask_helpers_are_the_originals():
    rng = np.random.default_rng(1)
    mask = (rng.uniform(size=(40, 29)) > 0.5).astype(np.float32)
    for size in (8, 96):
        np.testing.assert_array_equal(tmasks.resize_mask(mask, size),
                                      jmasks.resize_mask(mask, size))
        np.testing.assert_array_equal(
            tmasks.box_to_mask([0.1, 0.25, 0.6, 0.5], size),
            jmasks.box_to_mask([0.1, 0.25, 0.6, 0.5], size))
    bad = {"size": [4, 4], "counts": [3, 4]}
    for module in (tmasks, jmasks):
        with pytest.raises(ValueError, match="malformed RLE"):
            module.decode_rle(bad)


def _detections(rng, n_images=6, classes=4):
    preds, gts = [], []
    for _ in range(n_images):
        n = int(rng.integers(0, 6))
        g = rng.uniform(0, 60, (n, 4)).astype(np.float32)
        g[:, 2:] += 5
        gts.append({"boxes": g, "labels": rng.integers(2, 2 + classes, n),
                    "iscrowd": (rng.uniform(size=n) < 0.15).astype(int),
                    "area": g[:, 2] * g[:, 3] * rng.uniform(0.5, 1.5, n)})
        p = int(rng.integers(0, 10))
        d = np.concatenate([g + rng.normal(0, 3, g.shape),
                            rng.uniform(0, 60, (p, 4))]).astype(np.float32)
        d[:, 2:] = np.abs(d[:, 2:]) + 1
        scores = rng.uniform(size=len(d)).astype(np.float32)
        scores[:2] = 0.5  # a tie, kept in input order
        preds.append({"boxes": d, "scores": scores[:len(d)],
                      "labels": rng.integers(2, 2 + classes, len(d))})
    return preds, gts


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_compute_map_is_the_original():
    preds, gts = _detections(np.random.default_rng(2))
    _assert_same(tmet.compute_map(preds, gts), jmet.compute_map(preds, gts))
    ranges = {"all": (0.0, 1.0), "small": (0.0, 0.01)}
    _assert_same(tmet.compute_map(preds, gts, max_dets=(3, 50),
                                  area_ranges=ranges),
                 jmet.compute_map(preds, gts, max_dets=(3, 50),
                                  area_ranges=ranges))


def _raw_preds(rng, b=3, p=7, vc=6, va=5, s=12):
    logits = rng.standard_normal((b, p, vc)) * 2
    cat = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"category": cat.astype(np.float32),
            "attribute": rng.uniform(size=(b, p, va)).astype(np.float32),
            "boxes": rng.uniform(0, 0.6, (b, p, 4)).astype(np.float32),
            "masks": (rng.standard_normal((b, p, s, s)) * 3).astype(
                np.float32)}


def _batch(rng, b=3, o=4, va=5, s=12):
    n = np.array([0, 2, o])[:b]
    bbox = rng.uniform(0.05, 0.5, (b, o, 4)).astype(np.float32)
    masks = np.stack([[jmasks.box_to_mask(bbox[i, j], s) for j in range(o)]
                      for i in range(b)])
    return {"image": rng.uniform(size=(b, 8, 8, 3)).astype(np.float32),
            "num_objects": n, "bbox": bbox,
            "category_ids": rng.integers(2, 6, (b, o)),
            "attribute_ids": rng.integers(-1, va, (b, o, 3)),
            "iscrowd": (rng.uniform(size=(b, o)) < 0.2).astype(int),
            "orig_size": np.array([[480, 640], [300, 300], [640, 427]])[:b],
            "masks": masks.astype(np.float32)}


def test_eval_records_and_attribute_metrics_are_the_originals():
    rng = np.random.default_rng(3)
    preds = _raw_preds(rng)
    batch = _batch(rng)
    for thr in (0.0, 0.3):
        got = tmet.detr_predictions_to_eval(preds, thr)
        want = jmet.detr_predictions_to_eval(preds, thr)
        for g, w in zip(got, want):
            _assert_same(g, w)
    gts_t, gts_j = (m.batch_to_ground_truth(batch) for m in (tmet, jmet))
    for g, w in zip(gts_t, gts_j):
        _assert_same(g, w)
    hots = tmet.attribute_multihot_from_batch(batch, 5)
    for g, w in zip(hots, jmet.attribute_multihot_from_batch(batch, 5)):
        np.testing.assert_array_equal(g, w)
    records = jmet.detr_predictions_to_eval(preds)
    for rec, hot in zip(gts_j, hots):
        rec["attributes"] = hot
    # each detection a copy of a ground truth, so that matches happen
    for rec, gt in zip(records, gts_j):
        k = len(gt["boxes"])
        rec["boxes"][:k] = gt["boxes"]
        rec["labels"][:k] = gt["labels"]
    got = tmet.compute_attribute_metrics(records, gts_j)
    assert got["attr_matched"] > 0
    _assert_same(got, jmet.compute_attribute_metrics(records, gts_j))
    _assert_same(tmet.compute_attribute_metrics([], []),
                 jmet.compute_attribute_metrics([], []))


class _StubTrainer:
    """What ``evaluate_map`` and ``evaluate_pq`` read of a Trainer:
    ``predict(image, decode_text=False, use_ema=...)`` and ``model_cfg``."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.model_cfg = type("Cfg", (), {"image_size": (8, 8)})()
        self.calls = []

    def predict(self, image, decode_text=True, use_ema=False):
        assert decode_text is False
        self.calls.append(use_ema)
        return _raw_preds(self.rng, b=len(image))


def test_evaluate_map_and_pq_through_a_stub_trainer_are_the_originals():
    batches = [_batch(np.random.default_rng(s)) for s in (4, 5)]
    for use_ema in (False, True):
        got_t, got_j = _StubTrainer(6), _StubTrainer(6)
        _assert_same(tmet.evaluate_map(got_t, batches, use_ema=use_ema),
                     jmet.evaluate_map(got_j, batches, use_ema=use_ema))
        assert got_t.calls == got_j.calls == [use_ema] * 2
        pq_t = tmet.evaluate_pq(_StubTrainer(7), batches, 0.2, use_ema)
        pq_j = jmet.evaluate_pq(_StubTrainer(7), batches, 0.2, use_ema)
        _assert_same(pq_t, pq_j)

    def predict_fn(seed):
        stub = _StubTrainer(seed)
        return lambda image: stub.predict(image, decode_text=False)

    # without original sizes: the model's image size scales the boxes
    plain = [{k: v for k, v in b.items() if k != "orig_size"}
             for b in batches]
    for data in (batches, plain):
        _assert_same(tmet.evaluate_map_fn(predict_fn(8), data, (8, 8)),
                     jmet.evaluate_map_fn(predict_fn(8), data, (8, 8)))


def test_panoptic_segments_canvas_and_pq_are_the_originals():
    rng = np.random.default_rng(9)
    preds = _raw_preds(rng)
    for conf, min_pixels in ((0.2, 1), (0.4, 5)):
        got = tmet.detr_panoptic_segments(preds, conf, min_pixels)
        want = jmet.detr_panoptic_segments(preds, conf, min_pixels)
        for (gc, gs), (wc, ws) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gs, ws)
    batch = _batch(rng)
    gts = []
    for b in range(3):
        k = int(batch["num_objects"][b])
        cats = batch["category_ids"][b, :k]
        for scores in (None, rng.uniform(size=k)):
            canvas = tmet.panoptic_canvas(batch["masks"][b, :k], cats, scores)
            np.testing.assert_array_equal(
                canvas, jmet.panoptic_canvas(batch["masks"][b, :k], cats,
                                             scores))
        gts.append((canvas, cats.astype(np.int64),
                    batch["iscrowd"][b, :k].astype(bool)))
    segments = jmet.detr_panoptic_segments(preds, 0.2)
    # predictions that copy the ground truth's canvases, to score matches
    exact = [(c, s) for c, s, _ in gts]
    for pred in (segments, exact):
        _assert_same(tmet.compute_pq(gts, pred), jmet.compute_pq(gts, pred))
    assert jmet.compute_pq(gts, exact)["num_categories"] > 0
