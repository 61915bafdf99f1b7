"""Serving export: a standalone ``torch.export`` inference artifact.

Counterpart of boosted_detr_tpu/serving.py (``export_serving`` :39,
``ServingModel`` :122, ``load_serving`` :174). Export writes a
self-contained directory that a serving process loads without the model
code:

    model.pt2            ``torch.export.save`` of the eval-mode model's
                         program with its weights (the EMA shadow with
                         ``use_ema``); the batch dimension is a
                         ``torch.export.Dim``, so any batch size serves.
    serving_config.json  JAX's keys (image size, vocabulary, model class,
                         early exit and its criterion, EMA weights, the
                         outputs) and ``platforms``: the device the
                         program's weights lie on and it runs on.

``load_serving(path)`` returns a callable ``images [B,H,W,3] in [0,1] ->
(category_strings, attribute_strings, boxes, extras)`` (or the raw
probability dict with ``decode_text=False``), backed by the artifact alone.
``extras`` is a dict, always there and possibly empty, with the other
outputs ("masks" of a panoptic export, "exit_block" of an early-exit
export), so the decode return has a fixed arity for every model family.

``export_serving(..., early_exit=True)`` exports ``model(image,
return_intermediate=True)`` followed by ``early_exit.adaptive_select``
(``exit_criterion="confidence"``) or ``stability_select``
(``"stability"``): the artifact takes the threshold as a 0-d float32
tensor at run time and adds ``exit_block`` [B].

What differs from JAX, and why: the JAX artifact is StableHLO lowered for
several platforms; a ``torch.export`` program holds its weights on one
device, so ``platforms`` names one, ``"cuda"`` by default or ``"cpu"``. The
hand-written forward kernels are registered ops (``boosted_detr::
patchify_fwd``, ``boosted_detr::attention_fwd``; ops/patchify.py,
ops/attention.py) that the exported graph keeps as nodes: a program
exported for ``cuda`` launches the same kernels as the live model, and
counts its launches on the same counters, and the same program on the CPU
runs their plain versions. Loading needs those registrations only:
``ServingModel`` imports the two ops modules and the codec, never
``boosted_detr_torch.models``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

PROGRAM = "model.pt2"
CONFIG = "serving_config.json"
_PLATFORMS = ("cuda", "cpu")


def _platform(platforms: Union[str, Sequence[str]]) -> torch.device:
    names = [platforms] if isinstance(platforms, str) else list(platforms)
    if len(names) != 1 or names[0] not in _PLATFORMS:
        raise ValueError(f"platforms names the one device the artifact runs "
                         f"on, one of {_PLATFORMS}; got {platforms!r}")
    device = torch.device(names[0])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("an artifact for cuda needs a CUDA device; pass "
                           "platforms='cpu' to export for the CPU")
    return device


class _EarlyExitProgram(torch.nn.Module):
    """Every block's predictions, then each image's exit block by the
    criterion at a run-time threshold."""

    def __init__(self, model: torch.nn.Module, select):
        super().__init__()
        self.model = model
        self.select = select

    def forward(self, image: torch.Tensor, threshold: torch.Tensor):
        outs = self.model(image, return_intermediate=True)
        preds, exit_block = self.select(outs, threshold)
        return dict(preds, exit_block=exit_block)


def export_serving(trainer, path: str,
                   platforms: Union[str, Sequence[str]] = "cuda",
                   early_exit: bool = False,
                   exit_criterion: str = "confidence",
                   use_ema: bool = False) -> str:
    """Write ``trainer``'s inference program with its current weights to
    the directory ``path``; returns ``path``.

    ``early_exit=True`` exports the adaptive-select program: the artifact
    takes ``(images, threshold)`` and returns each image's earliest exiting
    block's predictions plus ``exit_block`` [B]. ``exit_criterion`` picks
    the rule: ``"confidence"`` (threshold = least confidence) or
    ``"stability"`` (threshold = largest delta between consecutive
    blocks; models/early_exit.py). ``use_ema=True`` exports the EMA shadow
    weights (``TrainConfig.ema_decay``) instead of the live ones.
    ``platforms`` is the device the artifact runs on (``"cuda"`` or
    ``"cpu"``); the model is copied there when it lies elsewhere."""
    import copy

    from boosted_detr_torch.models import early_exit as early_exit_lib
    from boosted_detr_torch.train import steps as steps_lib

    device = _platform(platforms)
    if early_exit and exit_criterion not in ("confidence", "stability"):
        raise ValueError(f"unknown exit_criterion: {exit_criterion!r}")
    trainer._require_state()
    state = (steps_lib.with_ema_params(trainer.state) if use_ema
             else trainer.state)
    model = state.model
    if next(model.parameters()).device.type != device.type:
        model = copy.deepcopy(model).to(device)
    h, w = trainer.model_cfg.image_size
    batch = torch.export.Dim("batch", min=1)
    image = torch.zeros((2, h, w, 3), dtype=torch.float32, device=device)
    if early_exit:
        select = (early_exit_lib.stability_select
                  if exit_criterion == "stability"
                  else early_exit_lib.adaptive_select)
        program = _EarlyExitProgram(model, select)
        args = (image, torch.zeros((), dtype=torch.float32, device=device))
        dims = ({0: batch}, None)
    else:
        program, args, dims = model, (image,), ({0: batch},)
    was_training = model.training
    program.eval()
    try:
        exported = torch.export.export(program, args, dynamic_shapes=dims)
    finally:
        model.train(was_training)
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, PROGRAM))
    meta = {
        "image_size": [h, w],
        "vocab_dict": (trainer.codec.vocab_dict
                       if trainer.codec is not None else None),
        "model_class": type(state.model).__name__,
        "early_exit": bool(early_exit),
        "exit_criterion": exit_criterion if early_exit else None,
        "ema_weights": bool(use_ema),
        "outputs": "dict(category softmax, attribute sigmoid, boxes COCO"
                   " [x,y,w,h]; masks logits when panoptic; exit_block when"
                   " early_exit)",
        "platforms": [device.type],
    }
    with open(os.path.join(path, CONFIG), "w") as f:
        json.dump(meta, f, indent=2)
    return path


class ServingModel:
    """Inference callable restored from an exported artifact (no model
    code, config or checkpoint needed)."""

    def __init__(self, path: str):
        # the forward kernels' op registrations, which the program names
        from boosted_detr_torch.ops import attention, patchify  # noqa: F401

        with open(os.path.join(path, CONFIG)) as f:
            self.meta = json.load(f)
        self.device = _platform(self.meta["platforms"])
        self.program = torch.export.load(os.path.join(path, PROGRAM))
        self._module = self.program.module()
        self.codec = None
        if self.meta.get("vocab_dict"):
            from boosted_detr_torch.data.codec import TextCodec

            self.codec = TextCodec(self.meta["vocab_dict"])

    def __call__(self, images, decode_text: bool = True,
                 threshold: Optional[float] = None):
        """Serve a batch (numpy, or a tensor on any device). The decode
        path returns the fixed-arity 4-tuple ``(category_strings,
        attribute_strings, boxes, extras)``; ``extras`` is a (possibly
        empty) dict with "masks" / "exit_block" where the artifact gives
        them. ``threshold`` sets the early-exit knob of an early-exit
        artifact, by its ``exit_criterion`` (least confidence, or largest
        stability delta); the default is the full-depth value of either
        (confidence 1.0, stability 0.0). A standard artifact refuses a
        threshold."""
        if isinstance(images, torch.Tensor):
            image = images.to(self.device, torch.float32)
        else:
            image = torch.from_numpy(np.asarray(images, np.float32)).to(
                self.device)
        with torch.inference_mode():
            if self.meta.get("early_exit"):
                if threshold is None:
                    threshold = (0.0 if self.meta.get("exit_criterion")
                                 == "stability" else 1.0)
                thr = torch.tensor(threshold, dtype=torch.float32,
                                   device=self.device)
                preds = self._module(image, thr)
            else:
                if threshold is not None:
                    raise ValueError(
                        "this artifact was exported without early_exit="
                        "True; re-export with export_serving(..., "
                        "early_exit=True) to serve a runtime threshold")
                preds = self._module(image)
        preds = {k: v.cpu().numpy() for k, v in preds.items()}
        if decode_text and self.codec is not None:
            decode_in = {k: v for k, v in preds.items()
                         if k in ("category", "attribute", "boxes")}
            cats, atts, boxes = self.codec.decode_predictions(decode_in)
            extras = {k: v for k, v in preds.items()
                      if k not in ("category", "attribute", "boxes")}
            return cats, atts, boxes, extras
        return preds


def load_serving(path: str) -> ServingModel:
    return ServingModel(path)
