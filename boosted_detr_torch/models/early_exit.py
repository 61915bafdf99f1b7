"""Early-exit (adaptive-depth) inference in PyTorch.

Counterpart of boosted_detr_tpu/models/early_exit.py. Two modes:

1. ``adaptive_select`` / ``stability_select``: every block runs, then each
   image takes its exit block from the per-block outputs
   (``predict(..., early_exit_threshold=...)`` in train/steps.py);
2. ``make_incremental_predict``: a plain Python loop over the blocks with
   one readback a block (the exit test), which stops once every image of
   the batch meets the criterion: the compute saving of early exit.

Two criteria: ``confidence`` (exit once the object-weighted confidence of
``block_confidence`` reaches the threshold) and ``stability`` (exit once
the next block's output moves by at most the threshold,
``prediction_delta``: the criterion for the boosted ensemble's cumulative
outputs, whose class-sum normalized confidence falls with depth).

The boosted ensemble's incremental route runs ``BoostedDETR.run_block``,
the forward's own block, in every mode: carried queries (``carry``), the
sticky freeze with its retained features and outputs (``confidence``),
one shared encoder run once before block 0, and a focused training layer,
at which the loop ends at the latest. Its output at the exit block is
therefore the forward's ``return_intermediate`` output there. JAX's
incremental boosted function (early_exit.py:246-300) differs from its
own ``BoostedDETR.__call__`` in those modes: it re-tiles fresh queries
and runs ``encoders[i]`` whatever the config says. The port is held to
the JAX model, not to that function.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from boosted_detr_torch.models.boosted import BoostedDETR

Preds = Dict[str, torch.Tensor]


def _class_normalized(preds: Preds) -> torch.Tensor:
    cat = preds["category"].float()
    return cat / cat.sum(-1, keepdim=True).clamp_min(1e-9)


def block_confidence(preds: Preds, pad_id: int = 0) -> torch.Tensor:
    """Per-image confidence [B]: the mean over slots of the max class
    probability (normalized by the class-sum, so that a boosted block's
    sum of k softmaxes compares with one softmax), each slot weighted by
    ``1 - p_PAD``; 1 for an image whose every slot is certain-PAD
    (early_exit.py:39-67)."""
    probs = _class_normalized(preds)
    maxp = probs.amax(dim=-1)
    obj_w = 1.0 - probs[..., pad_id]
    w_sum = obj_w.sum(dim=-1)
    conf = (obj_w * maxp).sum(dim=-1) / w_sum.clamp_min(1e-6)
    return torch.where(w_sum > 1e-3, conf, torch.ones_like(conf))


def prediction_delta(prev: Preds, cur: Preds, pad_id: int = 0
                     ) -> torch.Tensor:
    """Per-image change [B] between two consecutive blocks' outputs: the
    object-weighted mean over slots of the class total-variation distance
    (class-sum normalized) plus the mean |box move|, weighted by
    P(object) under ``cur``; 0 for an image with no object
    (early_exit.py:70-97)."""
    p0, p1 = _class_normalized(prev), _class_normalized(cur)
    tv = 0.5 * (p1 - p0).abs().sum(dim=-1)
    box = (cur["boxes"].float() - prev["boxes"].float()).abs().mean(dim=-1)
    obj_w = 1.0 - p1[..., pad_id]
    w_sum = obj_w.sum(dim=-1)
    delta = (obj_w * (tv + box)).sum(dim=-1) / w_sum.clamp_min(1e-6)
    return torch.where(w_sum > 1e-3, delta, torch.zeros_like(delta))


def _normalize_category(preds: Preds) -> Preds:
    """The category output as a per-slot distribution (float32), so that
    images that exit at different depths rank their scores alike
    (early_exit.py:100-115); the identity on a plain softmax."""
    return dict(preds, category=_class_normalized(preds))


def _gather_at(outputs: List[Preds], exit_block: torch.Tensor) -> Preds:
    """Each key of image b from block ``exit_block[b]``, the category
    renormalized (early_exit.py:118-130)."""
    rows = torch.arange(exit_block.shape[0], device=exit_block.device)
    idx = exit_block.long()
    return _normalize_category({
        k: torch.stack([o[k] for o in outputs])[idx, rows]
        for k in outputs[0]})


def _first_or_last(passed: torch.Tensor, offset: int) -> torch.Tensor:
    """Per column of ``passed`` [N, B], the first True row plus
    ``offset``, or ``N - 1 + offset`` where none is True; int32."""
    idx = passed.int().argmax(dim=0) + offset  # the first maximum
    last = torch.full_like(idx, passed.shape[0] - 1 + offset)
    return torch.where(passed.any(dim=0), idx, last).to(torch.int32)


def adaptive_select(outputs: List[Preds], threshold: float
                    ) -> Tuple[Preds, torch.Tensor]:
    """Per image the earliest block whose confidence reaches
    ``threshold``, else the last: (preds, exit_block [B])."""
    confs = torch.stack([block_confidence(o) for o in outputs])
    exit_block = _first_or_last(confs >= threshold, 0)
    return _gather_at(outputs, exit_block), exit_block


def stability_select(outputs: List[Preds], tau: float
                     ) -> Tuple[Preds, torch.Tensor]:
    """Per image the earliest block k >= 1 whose delta from block k-1 is
    at most ``tau``, else the last: (preds, exit_block [B])."""
    if len(outputs) == 1:
        b = outputs[0]["category"].shape[0]
        return (_normalize_category(outputs[0]),
                torch.zeros(b, dtype=torch.int32,
                            device=outputs[0]["category"].device))
    deltas = torch.stack([prediction_delta(outputs[k - 1], outputs[k])
                          for k in range(1, len(outputs))])
    exit_block = _first_or_last(deltas <= tau, 1)
    return _gather_at(outputs, exit_block), exit_block


def _make_stop_check(threshold: float, criterion: str
                     ) -> Callable[[Optional[Preds], Preds], bool]:
    """The batch's stop test, one readback: ``confidence`` once every
    image's confidence reaches ``threshold``, ``stability`` once every
    image's delta from the previous block is at most ``threshold`` (never
    at the first block)."""
    if criterion not in ("confidence", "stability"):
        raise ValueError(f"unknown early-exit criterion: {criterion!r}")

    def should_stop(prev: Optional[Preds], preds: Preds) -> bool:
        if criterion == "stability":
            if prev is None:
                return False
            return bool((prediction_delta(prev, preds) <= threshold).all())
        return bool((block_confidence(preds) >= threshold).all())

    return should_stop


@contextlib.contextmanager
def _inference(model: nn.Module) -> Iterator[None]:
    """Eval mode and no autograd, with the mode the model had put back."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def make_incremental_predict(model: nn.Module, threshold: float,
                             criterion: str = "confidence"
                             ) -> Callable[[torch.Tensor],
                                           Tuple[Preds, int]]:
    """Early exit with real compute saving: ``predict(image) -> (preds,
    blocks_run)`` for an image tensor on the model's device. ``DETR``
    encodes once and then runs one decoder block and the heads at a time;
    ``BoostedDETR`` runs one weak learner at a time, as its forward does
    in its query mode (``BoostedDETR.run_block``). Each block ends with
    the stop test; the category output comes back renormalized."""
    if isinstance(model, BoostedDETR):
        return _make_incremental_boosted(model, threshold, criterion)
    should_stop = _make_stop_check(threshold, criterion)
    n = model.config.num_decoder_blocks

    def predict(image: torch.Tensor) -> Tuple[Preds, int]:
        with _inference(model):
            tokens, pos = model.encode(image)
            enc_value, dec, enc_key, _ = model.decoder_prep(tokens, pos)
            prev = None
            for i in range(n):
                dec = getattr(model, f"decoder_block_{i}")(enc_value, dec,
                                                           enc_key)
                preds = model.apply_heads(dec)
                if should_stop(prev, preds):
                    break
                prev = preds
            return _normalize_category(preds), i + 1

    return predict


def _make_incremental_boosted(model: BoostedDETR, threshold: float,
                              criterion: str = "confidence"
                              ) -> Callable[[torch.Tensor],
                                            Tuple[Preds, int]]:
    """The boosted ensemble one weak learner at a time
    (``BoostedDETR.run_block``: its encoder, unless one shared encoder ran
    before block 0, its decoder block on fresh or carried queries, its
    heads, added to the sums or, under ``confidence``, merged with the
    frozen slots' outputs), the stop test after each, and no block past a
    focused training layer."""
    should_stop = _make_stop_check(threshold, criterion)

    def predict(image: torch.Tensor) -> Tuple[Preds, int]:
        with _inference(model):
            focused = model.focused_training_layer
            feats = model.neck(model.backbone(image))
            carry: Dict[str, object] = {}
            prev = None
            for i in range(model.config.num_decoder_blocks):
                out = model.run_block(i, feats, carry)
                if i == focused or should_stop(prev, out):
                    break
                prev = out
            return _normalize_category(out), i + 1

    return predict
