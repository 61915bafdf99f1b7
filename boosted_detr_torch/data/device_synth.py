"""The ``SyntheticShapes`` renderer on the card.

Counterpart of boosted_detr_tpu/data/device_synth.py: ``sample_scene``,
``rasterize``, ``scene_labels``, ``scene_masks``, ``render_image`` and
``make_batch_fn``. The procedural dataset of ``data/datasets.py``
(colored axis-aligned rectangles on a noisy background, later objects
over earlier ones) is rendered on the batch's device from seeded
``torch.Generator``s, so that a batch is made where the step runs and
never crosses the host.

Geometry, labels and colors follow the host renderer: the same size and
position distributions, the same pixel grid (``int`` truncation of
``x * s``), the same z-order overwrite, the same size and aspect
attribute rules. ``rasterize`` of a given scene and background equals the
host composition bit for bit, on any device.

A "dataset of N images" is emulated without storing any image: image i is
a function of ``(seed, i)`` alone (its own generator, seeded from both),
so a pool of N distinct images is a distribution of indices, and
``pool_size=None`` streams images that never repeat. The two packages'
random streams differ, so the images are not JAX's; the functions of a
scene are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from boosted_detr_torch.data.augment import _uniform
from boosted_detr_torch.data.datasets import SyntheticShapes
from boosted_detr_torch.data.pipeline import BOX_PAD_VALUE

_COLOR_NAMES = sorted(SyntheticShapes.COLORS)  # category id = 2 + index
_COLOR_RGB = np.asarray([SyntheticShapes.COLORS[c] for c in _COLOR_NAMES],
                        np.float32)
_ATT_NAMES = sorted(SyntheticShapes.SIZES + SyntheticShapes.ASPECTS)
_ATT_ID = {w: 2 + i for i, w in enumerate(_ATT_NAMES)}  # PAD=0, OOV=1


def sample_scene(generator: torch.Generator, max_objects: int,
                 min_objects: int, size_range: Tuple[float, float],
                 num_slots: int) -> Dict[str, torch.Tensor]:
    """One image's geometry on the generator's device, with the host
    renderer's distributions: per-slot [num_slots] tensors ``x``, ``y``,
    ``w``, ``h``, ``color``, ``active`` and the object count ``n``; slots
    >= n are inactive."""
    lo, hi = size_range
    n = torch.randint(min_objects, max_objects + 1, (), generator=generator,
                      device=generator.device)
    w = _uniform(generator, (num_slots,), lo, hi)
    h = _uniform(generator, (num_slots,), lo, hi)
    x = _uniform(generator, (num_slots,)) * (1.0 - w)
    y = _uniform(generator, (num_slots,)) * (1.0 - h)
    color = torch.randint(0, len(_COLOR_NAMES), (num_slots,),
                          generator=generator, device=generator.device)
    active = torch.arange(num_slots, device=generator.device) < n
    return {"n": n, "x": x, "y": y, "w": w, "h": h, "color": color,
            "active": active}


def draw_background(generator: torch.Generator, image_size: int
                    ) -> torch.Tensor:
    """The noisy background [s, s, 3], uniform in [0, 0.15)."""
    s = image_size
    return _uniform(generator, (s, s, 3), 0.0, 0.15)


def rasterize(background: torch.Tensor, scene: Dict[str, torch.Tensor],
              image_size: int) -> torch.Tensor:
    """``background`` [..., s, s, 3] with the scene's rectangles drawn over
    it in slot order on the host renderer's pixel grid: [y0, y1) x [x0, x1)
    with ``x0 = int(x s)``, ``x1 = max(x0 + 1, int((x + w) s))``. The
    scene's tensors are [..., num_slots]; leading dims batch images."""
    s = image_size
    dev = background.device
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    x0 = torch.floor(scene["x"] * s).to(torch.int32)
    y0 = torch.floor(scene["y"] * s).to(torch.int32)
    x1 = torch.maximum(x0 + 1, torch.floor((scene["x"] + scene["w"]) * s)
                       .to(torch.int32))
    y1 = torch.maximum(y0 + 1, torch.floor((scene["y"] + scene["h"]) * s)
                       .to(torch.int32))
    rgb = torch.from_numpy(_COLOR_RGB).to(dev)[scene["color"].long()]
    img = background
    # later slots overwrite earlier ones (z-order)
    for j in range(scene["x"].shape[-1]):
        def at(t):
            return t[..., j, None, None]

        mask = ((rows >= at(y0)) & (rows < at(y1)) & (cols >= at(x0))
                & (cols < at(x1)) & at(scene["active"]))[..., None]
        img = torch.where(mask, rgb[..., j, None, None, :], img)
    return img


def scene_labels(scene: Dict[str, torch.Tensor],
                 max_attribute_words: int = 8):
    """Scene -> (category_ids [..., O] int32, attribute_ids [..., O, W]
    int32, bbox [..., O, 4] float32, num_objects int32) with the host
    pipeline's conventions: category id = 2 + the sorted color index, the
    attribute words {size, aspect}, bbox pad -10.0."""
    active = scene["active"]
    zero = torch.zeros_like(scene["color"])
    cat = torch.where(active, scene["color"] + 2, zero).to(torch.int32)
    w, h = scene["w"], scene["h"]
    size_id = torch.where(w * h > 0.06, _ATT_ID["large"], _ATT_ID["small"])
    ratio = w / h
    aspect_id = torch.where(
        (ratio > 0.75) & (ratio < 1.33), _ATT_ID["square"],
        torch.where(w > h, _ATT_ID["wide"], _ATT_ID["tall"]))
    att = torch.zeros(*w.shape, max_attribute_words, dtype=torch.int32,
                      device=w.device)
    att[..., 0] = torch.where(active, size_id, 0).to(torch.int32)
    att[..., 1] = torch.where(active, aspect_id, 0).to(torch.int32)
    bbox = torch.stack([scene["x"], scene["y"], w, h], dim=-1)
    bbox = torch.where(active[..., None], bbox,
                       torch.full_like(bbox, BOX_PAD_VALUE))
    return cat, att, bbox.float(), scene["n"].to(torch.int32)


def scene_masks(scene: Dict[str, torch.Tensor], mask_size: int
                ) -> torch.Tensor:
    """Per-slot filled-box mask targets [..., num_slots, S, S] float32: the
    host pipeline's fallback without segmentation
    (``data/masks.py::box_to_mask``: the pixel centre (c + 0.5) / S in
    [lo, lo + extent)); inactive slots all zero."""
    s = mask_size
    dev = scene["x"].device
    centers = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    x, y, w, h = scene["x"], scene["y"], scene["w"], scene["h"]
    in_y = ((centers >= y[..., None]) & (centers < (y + h)[..., None]))
    in_x = ((centers >= x[..., None]) & (centers < (x + w)[..., None]))
    m = (in_y[..., :, None] & in_x[..., None, :]
         & scene["active"][..., None, None])
    return m.float()


def render_image(generator: torch.Generator, image_size: int,
                 max_objects: int, min_objects: int,
                 size_range: Tuple[float, float], num_slots: int,
                 max_attribute_words: int = 8,
                 mask_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One image and its labels from one generator, on its device: the
    scene, then the background. ``mask_size`` set -> the output carries
    ``masks`` [num_slots, S, S]."""
    scene = sample_scene(generator, max_objects, min_objects, size_range,
                         num_slots)
    image = rasterize(draw_background(generator, image_size), scene,
                      image_size)
    cat, att, bbox, n = scene_labels(scene, max_attribute_words)
    out = {"image": image, "category_ids": cat, "attribute_ids": att,
           "bbox": bbox, "num_objects": n}
    if mask_size:
        out["masks"] = scene_masks(scene, mask_size)
    return out


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


def make_batch_fn(image_size: int, batch_size: int, num_slots: int,
                  max_objects: int = 5, min_objects: int = 1,
                  size_range: Tuple[float, float] = (0.1, 0.6),
                  pool_size: Optional[int] = None, seed: int = 0,
                  max_attribute_words: int = 8,
                  mask_size: Optional[int] = None, device=None):
    """``batch_fn(step) -> batch`` of ``batch_size`` images rendered on
    ``device`` (``cuda`` unless the caller passes another).

    Image i is rendered from a generator on ``device`` seeded with
    ``(seed, 1, i)``. ``pool_size=None`` streams images ``step * batch_size
    + arange(batch_size)``, which never repeat; ``pool_size=N`` emulates a
    dataset of N distinct images, drawing each step's indices uniformly
    with replacement from a host generator seeded with ``(seed, 2,
    step)``. The defaults (1-5 objects, sides 0.1-0.6) are the val-suite
    protocol's."""
    from boosted_detr_torch.models.detr import _resolve_device

    device = _resolve_device(device)

    def batch_fn(step) -> Dict[str, torch.Tensor]:
        step = int(step)
        if pool_size is None:
            idx = [step * batch_size + j for j in range(batch_size)]
        else:
            pick = np.random.default_rng(_seed(seed, 2, step))
            idx = pick.integers(0, pool_size, batch_size).tolist()
        scenes, backgrounds = [], []
        for i in idx:  # each image's draws, in render_image's order
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed(seed, 1, i))
            scenes.append(sample_scene(gen, max_objects, min_objects,
                                       size_range, num_slots))
            backgrounds.append(draw_background(gen, image_size))
        scene = {k: torch.stack([sc[k] for sc in scenes]) for k in scenes[0]}
        # one composition for the whole batch
        image = rasterize(torch.stack(backgrounds), scene, image_size)
        cat, att, bbox, n = scene_labels(scene, max_attribute_words)
        out = {"image": image, "category_ids": cat, "attribute_ids": att,
               "bbox": bbox, "num_objects": n}
        if mask_size:
            out["masks"] = scene_masks(scene, mask_size)
        return out

    return batch_fn
