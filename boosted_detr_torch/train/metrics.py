"""COCO-protocol mAP/AR, attribute metrics and Panoptic Quality (numpy).

A copy of boosted_detr_tpu/train/metrics.py (numpy only; the port imports
nothing of the JAX package): ``compute_map`` and its helpers (pycocotools'
rules: AP over IoU 0.50:0.95, 101-point interpolated PR, area ranges,
crowd regions, maxDets, a stable score sort), ``detr_predictions_to_eval``,
``compute_attribute_metrics``, ``batch_to_ground_truth``,
``evaluate_map_fn`` and ``evaluate_map``; and ``panoptic_canvas``,
``detr_panoptic_segments``, ``compute_pq`` and ``evaluate_pq`` (the
panopticapi rules). ``evaluate_map`` and ``evaluate_pq`` duck-type on a
trainer's ``predict(image, decode_text=False, use_ema=...)`` and
``model_cfg``. Class 0 (<PAD>) is the no-object class and is excluded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(det: np.ndarray, gt: np.ndarray,
                crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise IoU of COCO-format [x, y, w, h] boxes [len(det), len(gt)].
    Columns whose ``crowd`` flag is set use intersection / detection-area
    (the pycocotools crowd rule)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)), np.float32)
    dx0, dy0 = det[:, 0], det[:, 1]
    dx1 = det[:, 0] + np.maximum(det[:, 2], 0)
    dy1 = det[:, 1] + np.maximum(det[:, 3], 0)
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1 = gt[:, 0] + np.maximum(gt[:, 2], 0)
    gy1 = gt[:, 1] + np.maximum(gt[:, 3], 0)
    ix0 = np.maximum(dx0[:, None], gx0[None, :])
    iy0 = np.maximum(dy0[:, None], gy0[None, :])
    ix1 = np.minimum(dx1[:, None], gx1[None, :])
    iy1 = np.minimum(dy1[:, None], gy1[None, :])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    area_d = (dx1 - dx0) * (dy1 - dy0)
    area_g = (gx1 - gx0) * (gy1 - gy0)
    union = area_d[:, None] + area_g[None, :] - inter
    if crowd is not None and crowd.any():
        union = np.where(crowd[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_image(ious: np.ndarray, gt_ignore: np.ndarray,
                 thresholds: np.ndarray, gt_crowd: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """pycocotools evalImg matching. ``ious`` [D, G] with gts ordered
    valid-first; returns (dt_match [T, D] gt-index+1 or 0,
    dt_ignore [T, D])."""
    n_d, n_g = ious.shape
    n_t = len(thresholds)
    dtm = np.zeros((n_t, n_d), np.int64)
    dt_ig = np.zeros((n_t, n_d), bool)
    gtm = np.zeros((n_t, n_g), np.int64)
    for ti, t in enumerate(thresholds):
        for d in range(n_d):
            best = min(t, 1 - 1e-10)
            m = -1
            for g in range(n_g):
                if gtm[ti, g] > 0 and not gt_crowd[g]:
                    continue  # taken (crowds may absorb many detections)
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break  # valid match held; rest are ignored gts
                if ious[d, g] < best:
                    continue
                best = ious[d, g]
                m = g
            if m == -1:
                continue
            dtm[ti, d] = m + 1
            dt_ig[ti, d] = gt_ignore[m]
            gtm[ti, m] = d + 1
    return dtm, dt_ig


def _interp_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolation (precision envelope, searchsorted 'left')."""
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    prec_at = np.where(idx < len(precision),
                       precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(prec_at.mean())


def compute_map(predictions: Sequence[Dict[str, np.ndarray]],
                ground_truths: Sequence[Dict[str, np.ndarray]],
                iou_thresholds: Optional[np.ndarray] = None,
                max_dets: Sequence[int] = MAX_DETS,
                area_ranges: Optional[Dict[str, Tuple[float, float]]] = None
                ) -> Dict[str, float]:
    """Full COCO-protocol evaluation.

    Args:
      predictions: per image: {'boxes' [P,4] COCO [x,y,w,h], 'scores' [P],
        'labels' [P] int}.
      ground_truths: per image: {'boxes' [n,4], 'labels' [n] int, optional
        'iscrowd' [n] 0/1, optional 'area' [n] (defaults to w*h)}.
      max_dets: detection caps; AP uses the largest, AR reported per cap.
      area_ranges: name -> (lo, hi) area bounds; default COCO pixel ranges
        (pass custom ranges for normalized boxes).

    Returns the COCO metric dict: mAP, mAP50, mAP75, mAP_small/medium/large,
    AR@k per max_dets cap, AR_small/medium/large, per_class.
    """
    thresholds = (IOU_THRESHOLDS if iou_thresholds is None
                  else np.asarray(iou_thresholds))
    ranges = AREA_RANGES if area_ranges is None else area_ranges
    max_dets = sorted(int(m) for m in np.atleast_1d(max_dets))
    top_det = max_dets[-1]
    assert len(predictions) == len(ground_truths)

    classes = sorted(
        {int(l) for gt in ground_truths for l in np.asarray(gt["labels"])})
    n_t, n_k = len(thresholds), len(classes)

    # ---- per (class, image): match once per area range ----
    # eval[(ci, area)][img] = (scores, dtm [T,D], dt_ig [T,D], npig)
    evals: Dict[Tuple[int, str], List] = {
        (ci, a): [] for ci in range(n_k) for a in ranges}
    for pred, gt in zip(predictions, ground_truths):
        p_labels = np.asarray(pred["labels"])
        p_boxes = np.asarray(pred["boxes"], np.float32).reshape(-1, 4)
        p_scores = np.asarray(pred["scores"], np.float32)
        g_labels = np.asarray(gt["labels"])
        g_boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
        g_crowd = np.asarray(gt.get("iscrowd",
                                    np.zeros(len(g_labels)))).astype(bool)
        g_area = np.asarray(gt.get(
            "area", np.maximum(g_boxes[:, 2], 0) * np.maximum(g_boxes[:, 3],
                                                              0)),
            np.float32)
        d_area = np.maximum(p_boxes[:, 2], 0) * np.maximum(p_boxes[:, 3], 0)

        for ci, cls in enumerate(classes):
            dm = p_labels == cls
            gm = g_labels == cls
            d_idx = np.nonzero(dm)[0]
            # stable score sort + cap at the largest maxDets
            order = np.argsort(-p_scores[d_idx], kind="stable")[:top_det]
            d_idx = d_idx[order]
            scores = p_scores[d_idx]
            areas_d = d_area[d_idx]
            boxes_d = p_boxes[d_idx]
            g_idx = np.nonzero(gm)[0]
            # IoUs depend only on (image, class) — compute once and permute
            # columns per area range (pycocotools' computeIoU/evalImg split)
            ious_all = _iou_matrix(boxes_d, g_boxes[g_idx], g_crowd[g_idx])
            for name, (lo, hi) in ranges.items():
                ig = g_crowd[g_idx] | (g_area[g_idx] < lo) | (
                    g_area[g_idx] > hi)
                # valid gts first (stable), matching pycocotools' gtIg sort
                gorder = np.argsort(ig, kind="stable")
                gi = g_idx[gorder]
                ious = ious_all[:, gorder]
                dtm, dt_ig = _match_image(ious, ig[gorder], thresholds,
                                          g_crowd[gi])
                out_of_range = (areas_d < lo) | (areas_d > hi)
                dt_ig = dt_ig | ((dtm == 0) & out_of_range[None, :])
                npig = int((~ig).sum())
                evals[(ci, name)].append((scores, dtm, dt_ig, npig))

    # ---- accumulate ----
    # precision[T, K, A, M] and recall[T, K, A, M]; -1 = undefined
    n_a, n_m = len(ranges), len(max_dets)
    ap = np.full((n_t, n_k, n_a, n_m), -1.0)
    ar = np.full((n_t, n_k, n_a, n_m), -1.0)
    for ci in range(n_k):
        for ai, name in enumerate(ranges):
            per_img = evals[(ci, name)]
            for mi, md in enumerate(max_dets):
                scores = np.concatenate([e[0][:md] for e in per_img]) \
                    if per_img else np.zeros(0)
                npig = sum(e[3] for e in per_img)
                if npig == 0:
                    continue
                order = np.argsort(-scores, kind="stable")
                if per_img:
                    dtm = np.concatenate([e[1][:, :md] for e in per_img],
                                         axis=1)[:, order]
                    dt_ig = np.concatenate([e[2][:, :md] for e in per_img],
                                           axis=1)[:, order]
                else:
                    dtm = np.zeros((n_t, 0))
                    dt_ig = np.zeros((n_t, 0), bool)
                tps = (dtm > 0) & ~dt_ig
                fps = (dtm == 0) & ~dt_ig
                for ti in range(n_t):
                    tp = np.cumsum(tps[ti])
                    fp = np.cumsum(fps[ti])
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, 1e-12)
                    ar[ti, ci, ai, mi] = rc[-1] if nd else 0.0
                    ap[ti, ci, ai, mi] = _interp_ap(rc, pr) if nd else 0.0

    # pycocotools summarize() convention: a metric with no defined entries
    # (no ground truth in the area range anywhere in the dataset) is -1.0.
    def mean_ap(t_sel=None, area="all", md=top_det):
        ai = list(ranges).index(area)
        mi = max_dets.index(md)
        sub = ap[:, :, ai, mi] if t_sel is None else ap[t_sel, :, ai, mi]
        valid = sub > -1
        return float(sub[valid].mean()) if valid.any() else -1.0

    def mean_ar(area="all", md=top_det):
        ai = list(ranges).index(area)
        mi = max_dets.index(md)
        sub = ar[:, :, ai, mi]
        valid = sub > -1
        return float(sub[valid].mean()) if valid.any() else -1.0

    i50 = int(np.argmin(np.abs(thresholds - 0.50)))
    i75 = int(np.argmin(np.abs(thresholds - 0.75)))
    per_class = {}
    mi = max_dets.index(top_det)
    ai_all = list(ranges).index("all") if "all" in ranges else 0
    for ci, cls in enumerate(classes):
        sub = ap[:, ci, ai_all, mi]
        if (sub > -1).any():
            per_class[cls] = float(sub[sub > -1].mean())

    result = {
        "mAP": mean_ap(),
        "mAP50": mean_ap(t_sel=i50),
        "mAP75": mean_ap(t_sel=i75),
        "per_class": per_class,
    }
    for name in ranges:
        if name != "all":
            result[f"mAP_{name}"] = mean_ap(area=name)
            result[f"AR_{name}"] = mean_ar(area=name)
    for md in max_dets:
        result[f"AR@{md}"] = mean_ar(md=md)
    return result


def detr_predictions_to_eval(preds: Dict[str, np.ndarray],
                             score_threshold: float = 0.0
                             ) -> List[Dict[str, np.ndarray]]:
    """Model output dict -> per-image eval records. Score = max non-PAD/OOV
    class probability; label = argmax over real classes (ids >= 2); the
    <PAD>=0 no-object slot (and OOV=1) are excluded. When the model emits an
    ``attribute`` head, its per-slot multi-label probabilities ride along
    (consumed by ``compute_attribute_metrics``)."""
    cat = np.asarray(preds["category"])  # [B, P, Vc]
    boxes = np.asarray(preds["boxes"])  # [B, P, 4]
    att = (np.asarray(preds["attribute"], np.float32)
           if "attribute" in preds else None)
    real = cat[:, :, 2:]
    labels = real.argmax(-1) + 2
    scores = real.max(-1)
    out = []
    for i in range(cat.shape[0]):
        keep = scores[i] >= score_threshold
        rec = {"boxes": boxes[i][keep], "scores": scores[i][keep],
               "labels": labels[i][keep]}
        if att is not None:
            rec["attributes"] = att[i][keep]
        out.append(rec)
    return out


def attribute_multihot_from_batch(batch: Dict[str, np.ndarray],
                                  num_attributes: int
                                  ) -> List[np.ndarray]:
    """Per-image ground-truth attribute multi-hot [n, Va] from the pipeline's
    padded ``attribute_ids`` [B, O, W] (host-side analogue of the device
    ``targets_from_batch``, train/steps.py)."""
    ids = np.asarray(batch["attribute_ids"])
    out = []
    for i in range(len(batch["num_objects"])):
        n = int(batch["num_objects"][i])
        hot = np.zeros((n, num_attributes), np.float32)
        for j in range(n):
            for a in ids[i, j]:
                if 0 <= int(a) < num_attributes:
                    hot[j, int(a)] = 1.0
        out.append(hot)
    return out


def compute_attribute_metrics(predictions: Sequence[Dict[str, np.ndarray]],
                              ground_truths: Sequence[Dict[str, np.ndarray]],
                              iou_threshold: float = 0.5,
                              prob_threshold: float = 0.5
                              ) -> Dict[str, float]:
    """Multi-label attribute quality over MATCHED detections (the reference's
    second headline feature: the attributes head,
    reference prediction_heads.py:140-207, decoded at a 0.5 probability
    threshold by InverseTokenization, reference tokenizers.py:122-156).

    Matching mirrors the detection protocol at IoU 0.50: per image and
    category, detections in descending score order greedily take the
    unmatched ground truth with the highest IoU >= ``iou_threshold``. Over
    the matched (detection, ground-truth) pairs:

    - ``attr_F1`` / ``attr_precision`` / ``attr_recall``: micro-averaged
      set overlap of the DECODED attributes (prob >= ``prob_threshold``,
      ids >= 2 — <PAD>/<OOV> excluded, matching the reference's decode);
    - ``attr_mAP``: macro mean over attributes (with >= 1 positive) of
      average precision, ranking matched detections by that attribute's
      probability — threshold-free ranking quality;
    - ``attr_match_recall``: fraction of ground-truth objects that received
      a matched detection (the conditioning set's coverage).

    predictions per image: {'boxes', 'scores', 'labels', 'attributes'
    [P, Va]}; ground_truths: {'boxes', 'labels', 'attributes' [n, Va]}.
    """
    pair_pred: List[np.ndarray] = []   # [Va] probs per matched detection
    pair_gt: List[np.ndarray] = []     # [Va] multi-hot per matched gt
    total_gt = 0
    for pred, gt in zip(predictions, ground_truths):
        g_boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
        g_labels = np.asarray(gt["labels"])
        g_att = np.asarray(gt["attributes"], np.float32)
        total_gt += len(g_labels)
        if len(g_labels) == 0 or len(pred["scores"]) == 0:
            continue
        p_boxes = np.asarray(pred["boxes"], np.float32).reshape(-1, 4)
        p_scores = np.asarray(pred["scores"], np.float32)
        p_labels = np.asarray(pred["labels"])
        p_att = np.asarray(pred["attributes"], np.float32)
        taken = np.zeros(len(g_labels), bool)
        order = np.argsort(-p_scores, kind="stable")
        ious = _iou_matrix(p_boxes, g_boxes)
        for d in order:
            cand = np.nonzero((g_labels == p_labels[d]) & ~taken
                              & (ious[d] >= iou_threshold))[0]
            if cand.size == 0:
                continue
            g = cand[np.argmax(ious[d, cand])]
            taken[g] = True
            pair_pred.append(p_att[d])
            pair_gt.append(g_att[g])

    if not pair_pred:
        return {"attr_F1": 0.0, "attr_precision": 0.0, "attr_recall": 0.0,
                "attr_mAP": 0.0, "attr_match_recall": 0.0,
                "attr_matched": 0}
    pp = np.stack(pair_pred)[:, 2:]  # drop <PAD>/<OOV> columns
    gg = np.stack(pair_gt)[:, 2:]
    dec = pp >= prob_threshold
    pos = gg > 0.5
    tp = float((dec & pos).sum())
    precision = tp / max(float(dec.sum()), 1e-12)
    recall = tp / max(float(pos.sum()), 1e-12)
    f1 = (2 * precision * recall / max(precision + recall, 1e-12)
          if (precision + recall) else 0.0)

    aps = []
    for a in range(pp.shape[1]):
        n_pos = int(pos[:, a].sum())
        if n_pos == 0:
            continue
        order = np.argsort(-pp[:, a], kind="stable")
        hits = pos[order, a]
        cum = np.cumsum(hits)
        prec_at_hit = cum[hits] / (np.nonzero(hits)[0] + 1)
        aps.append(float(prec_at_hit.sum()) / n_pos)
    return {
        "attr_F1": f1, "attr_precision": precision, "attr_recall": recall,
        "attr_mAP": float(np.mean(aps)) if aps else 0.0,
        "attr_match_recall": len(pair_pred) / max(total_gt, 1),
        "attr_matched": len(pair_pred),
    }


def batch_to_ground_truth(batch: Dict[str, np.ndarray]
                          ) -> List[Dict[str, np.ndarray]]:
    """Pipeline batch -> per-image ground-truth records. Crowd flags and
    per-object annotation ``area`` (original-image pixels, pycocotools'
    area source) pass through when the pipeline provides them."""
    out = []
    b = len(batch["num_objects"])
    for i in range(b):
        n = int(batch["num_objects"][i])
        rec = {"boxes": np.asarray(batch["bbox"][i][:n], np.float32),
               "labels": np.asarray(batch["category_ids"][i][:n])}
        if "iscrowd" in batch:
            rec["iscrowd"] = np.asarray(batch["iscrowd"][i][:n])
        if "area" in batch:
            rec["area"] = np.asarray(batch["area"][i][:n], np.float32)
        out.append(rec)
    return out


def evaluate_map_fn(predict_fn, batches,
                    image_size) -> Dict[str, float]:
    """Run ``predict_fn(image) -> {"category", "boxes", ...}`` over batches
    and compute COCO mAP.

    Boxes are normalized; each image's boxes are scaled to its ORIGINAL
    pixel size (``batch["orig_size"]`` [B, 2] = [h, w], falling back to the
    model's resized ``image_size``) so the COCO pixel area ranges
    (32^2/96^2) bucket detections the way pycocotools does on non-square
    originals. Ground-truth areas use the annotation's own ``area`` when the
    pipeline provides it (segmentation area, pycocotools' source).

    When the model emits an ``attribute`` head AND the batches carry
    ``attribute_ids``, the result also includes the attribute-quality
    metrics from ``compute_attribute_metrics`` (reference headline feature,
    prediction_heads.py:140)."""
    preds_all: List[Dict] = []
    gts_all: List[Dict] = []
    sizes: List[Tuple[int, int]] = []  # per-image (h, w)
    for batch in batches:
        preds = detr_predictions_to_eval(predict_fn(batch["image"]))
        gts = batch_to_ground_truth(batch)
        if "attribute_ids" in batch and preds and "attributes" in preds[0]:
            num_att = preds[0]["attributes"].shape[-1]
            for rec, hot in zip(gts, attribute_multihot_from_batch(
                    batch, num_att)):
                rec["attributes"] = hot
        preds_all.extend(preds)
        gts_all.extend(gts)
        if "orig_size" in batch:
            sizes.extend((int(h), int(w)) for h, w in
                         np.asarray(batch["orig_size"]))
        else:
            sizes.extend([tuple(image_size)] * len(batch["num_objects"]))

    def scale(recs):
        return [dict(r, boxes=np.asarray(r["boxes"], np.float32)
                     * np.asarray([w, h, w, h], np.float32))
                for r, (h, w) in zip(recs, sizes)]

    result = compute_map(scale(preds_all), scale(gts_all))
    if gts_all and "attributes" in gts_all[0]:
        # attribute matching happens in normalized coords (IoU is
        # scale-invariant for the square-resized eval; use unscaled recs)
        result.update(compute_attribute_metrics(preds_all, gts_all))
    return result


def evaluate_map(trainer, batches, use_ema: bool = False) -> Dict[str, float]:
    """evaluate_map_fn driven by a Trainer (the standard entry point).
    ``use_ema`` evaluates the EMA shadow weights (TrainConfig.ema_decay)."""
    return evaluate_map_fn(
        lambda image: trainer.predict(image, decode_text=False,
                                      use_ema=use_ema), batches,
        trainer.model_cfg.image_size)


# ---------------------------------------------------------------------------
# Panoptic Quality (PQ / SQ / RQ)
# ---------------------------------------------------------------------------

VOID = -1


def panoptic_canvas(masks: np.ndarray, categories: np.ndarray,
                    scores: Optional[np.ndarray] = None) -> np.ndarray:
    """Resolve per-segment binary ``masks`` [N, H, W] into one NON-overlapping
    int32 canvas of segment indices (VOID = -1 where nothing claims the
    pixel). Overlaps go to the segment with the higher ``scores`` value
    (for predictions: the mask logit is passed per-pixel instead — see
    ``detr_panoptic_segments``); with ``scores=None`` the LATER segment wins,
    matching a painter's-order renderer (SyntheticShapes draws objects
    sequentially, so later objects occlude earlier ones)."""
    n, h, w = masks.shape
    canvas = np.full((h, w), VOID, np.int32)
    order = range(n) if scores is None else np.argsort(scores, kind="stable")
    for i in order:
        canvas[masks[i] > 0] = i
    del categories  # categories are read by the caller via the index canvas
    return canvas


def detr_panoptic_segments(preds: Dict[str, np.ndarray],
                           confidence: float = 0.5,
                           min_pixels: int = 1
                           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """DETR-style panoptic postprocess (one entry per image): keep queries
    whose best non-PAD class probability clears ``confidence``, assign each
    pixel to the kept query with the highest mask logit — but only where
    that logit is positive (sigmoid > 0.5), everything else is VOID — and
    drop empty/tiny segments. Returns [(canvas [H, W] of segment ids,
    segment category ids [S])] per image; ids index the second array."""
    cat = np.asarray(preds["category"], np.float32)      # [B, P, Vc] softmax
    logits = np.asarray(preds["masks"], np.float32)      # [B, P, H, W]
    out = []
    for b in range(cat.shape[0]):
        cls = cat[b, :, 1:].argmax(-1) + 1               # best non-PAD class
        score = cat[b, :, 1:].max(-1)
        keep = np.nonzero(score >= confidence)[0]
        h, w = logits.shape[2:]
        canvas = np.full((h, w), VOID, np.int32)
        seg_cats: List[int] = []
        if keep.size:
            ml = logits[b, keep]                          # [K, H, W]
            winner = ml.argmax(0)
            claimed = ml.max(0) > 0.0                     # sigmoid > 0.5
            flat = np.where(claimed, winner, -1)
            kept_ids = []
            for j in range(keep.size):
                sel = flat == j
                if sel.sum() >= min_pixels:
                    canvas[sel] = len(kept_ids)
                    kept_ids.append(j)
                    seg_cats.append(int(cls[keep[j]]))
        out.append((canvas, np.asarray(seg_cats, np.int64)))
    return out


def compute_pq(gt_images: Sequence[Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]],
               pred_images: Sequence[Tuple[np.ndarray, np.ndarray]]
               ) -> Dict[str, float]:
    """Panoptic Quality over a dataset (Kirillov et al., the panopticapi
    rules — pure numpy; the reference has no panoptic metric at all):

    - per image, segments match when SAME category and IoU > 0.5 (at most
      one match each — guaranteed unique by the > 0.5 rule);
    - IoU's union EXCLUDES the prediction's overlap with VOID pixels
      (unlabeled area is not evidence against a match);
    - crowd ground truths (``gt_iscrowd``) never match and never count as
      FN; an unmatched prediction is discarded (not an FP) when more than
      half its area lies on VOID + same-category crowd pixels;
    - PQ = sum(IoU of TPs) / (TP + FP/2 + FN/2), SQ = sum(IoU)/TP,
      RQ = TP / (TP + FP/2 + FN/2), averaged over categories that appear
      in the ground truth or predictions (panopticapi convention).

    ``gt_images``: (canvas [H, W] of segment ids or VOID, categories [S],
    iscrowd [S] or None). ``pred_images``: (canvas, categories)."""
    per_cat: Dict[int, Dict[str, float]] = {}

    def cat_stats(c):
        return per_cat.setdefault(c, dict(iou=0.0, tp=0, fp=0, fn=0))

    for (gt_canvas, gt_cats, gt_crowd), (pr_canvas, pr_cats) in zip(
            gt_images, pred_images):
        gt_crowd = (np.zeros(len(gt_cats), bool) if gt_crowd is None
                    else np.asarray(gt_crowd, bool))
        gt_areas = np.bincount(gt_canvas[gt_canvas >= 0].ravel(),
                               minlength=len(gt_cats)).astype(np.int64)
        pr_areas = np.bincount(pr_canvas[pr_canvas >= 0].ravel(),
                               minlength=len(pr_cats)).astype(np.int64)
        void_mask = gt_canvas == VOID
        # pairwise intersections via a joint id (gt+1) * M + (pr+1)
        m = len(pr_cats) + 1
        joint = (gt_canvas.astype(np.int64) + 1) * m + (
            pr_canvas.astype(np.int64) + 1)
        ids, counts = np.unique(joint, return_counts=True)
        inter = {(int(i // m) - 1, int(i % m) - 1): int(c)
                 for i, c in zip(ids, counts)}
        gt_matched = np.zeros(len(gt_cats), bool)
        pr_matched = np.zeros(len(pr_cats), bool)
        for (g, p), n_int in inter.items():
            if g < 0 or p < 0 or gt_crowd[g]:
                continue
            if gt_cats[g] != pr_cats[p]:
                continue
            void_int = inter.get((VOID, p), 0)
            union = gt_areas[g] + pr_areas[p] - n_int - void_int
            iou = n_int / union if union > 0 else 0.0
            if iou > 0.5:
                s = cat_stats(int(gt_cats[g]))
                s["iou"] += iou
                s["tp"] += 1
                gt_matched[g] = True
                pr_matched[p] = True
        for g in np.nonzero(~gt_matched & ~gt_crowd)[0]:
            cat_stats(int(gt_cats[g]))["fn"] += 1
        for p in np.nonzero(~pr_matched)[0]:
            ignore = inter.get((VOID, p), 0)
            for g in np.nonzero(gt_crowd)[0]:
                if gt_cats[g] == pr_cats[p]:
                    ignore += inter.get((int(g), int(p)), 0)
            if pr_areas[p] > 0 and ignore / pr_areas[p] > 0.5:
                continue
            cat_stats(int(pr_cats[p]))["fp"] += 1

    pqs, sqs, rqs = [], [], []
    for c, s in sorted(per_cat.items()):
        denom = s["tp"] + 0.5 * s["fp"] + 0.5 * s["fn"]
        if denom == 0:
            continue
        pq = s["iou"] / denom
        sq = s["iou"] / s["tp"] if s["tp"] else 0.0
        rq = s["tp"] / denom
        pqs.append(pq)
        sqs.append(sq)
        rqs.append(rq)
    n = max(len(pqs), 1)
    return {"PQ": float(sum(pqs)) / n, "SQ": float(sum(sqs)) / n,
            "RQ": float(sum(rqs)) / n, "num_categories": len(pqs)}


def evaluate_pq(trainer, batches, confidence: float = 0.5,
                use_ema: bool = False) -> Dict[str, float]:
    """PQ/SQ/RQ for a DETRPanoptic trainer over mask-target batches (the
    batch must carry 'masks' [B, O, h, w] + 'category_ids'/'num_objects';
    prediction masks are produced at the model's own mask resolution, so
    ground-truth and prediction canvases share a grid)."""
    gt_images, pred_images = [], []
    for batch in batches:
        preds = trainer.predict(batch["image"], decode_text=False,
                                use_ema=use_ema)
        pred_images.extend(detr_panoptic_segments(preds, confidence))
        n_obj = np.asarray(batch["num_objects"], np.int64)
        cats = np.asarray(batch["category_ids"])
        masks = np.asarray(batch["masks"])
        crowd_all = batch.get("iscrowd")
        for b in range(masks.shape[0]):
            k = int(n_obj[b])
            canvas = panoptic_canvas(masks[b, :k], cats[b, :k])
            crowd = (np.asarray(crowd_all[b, :k], bool)
                     if crowd_all is not None else None)
            gt_images.append((canvas, cats[b, :k].astype(np.int64), crowd))
    return compute_pq(gt_images, pred_images)
