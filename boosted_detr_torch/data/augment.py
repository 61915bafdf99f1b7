"""Batched image augmentations on the batch's device.

Counterpart of boosted_detr_tpu/data/augment.py, which runs them jitted on
the accelerator: a random per-axis shrink, shift and zero pad with the box
and mask transform (:38), contrast, brightness and saturation jitter, then
a clip to [0, 1]; and the host extras ``host_jpeg_quality`` and
``host_augment``.

Each random transform is split into its draws and a pure function of
them: ``draw_augmentations(generator, batch_size)`` draws every image's
numbers from a ``torch.Generator`` (JAX takes a key), and
``apply_augmentations(batch, draws)`` is arithmetic alone, the JAX
package's with the same draws (the two packages' random streams cannot
match). ``augment_batch(generator, batch)`` is the two together; the
``random_*`` functions and ``augment_one`` do the same for one image.

The draws, per image, as the JAX package draws them:
- ``shrink`` [B, 2]: (f_h, f_w), each ``max(1, 0.5 + 0.7 t)`` with t from
  a standard normal truncated to [-2, 2];
- ``shift`` [B, 2]: (u_h, u_w) uniform in [0, 1); the image's new origin
  is ``u (1 - 1 / f)`` along each axis;
- ``contrast`` [B] in [0.8, 1.2), ``brightness`` [B] in [-0.1, 0.1),
  ``saturation`` [B] in [0.8, 1.2).

The shrink is ``jax.image.scale_and_translate`` with the ``linear``
method: a triangle kernel widened by the shrink factor (it antialiases,
since every scale is at most 1), weights normalised over each output
sample and zero where the sample falls outside the input. It is written
out here as two weight matrices per image; the image is the product with
both. The boxes take the width factor on x and w and the height factor on
y and h (the JAX package's fix of the reference's swapped axes); pad boxes
(-10) pass through the same affine and stay far outside [0, 1].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

SHRINK_MEAN, SHRINK_STD = 0.5, 0.7
CONTRAST = (0.8, 1.2)
BRIGHTNESS = 0.1
SATURATION = (0.8, 1.2)
GRAY = (0.2989, 0.587, 0.114)


def _uniform(generator: torch.Generator, shape, low=0.0, high=1.0):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (high - low) + low


def _shrink(generator: torch.Generator, shape) -> torch.Tensor:
    """max(1, TruncatedNormal(mean=.5, std=.7) on [-2 sigma, 2 sigma])."""
    t = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return torch.clamp(t * SHRINK_STD + SHRINK_MEAN, min=1.0)


def draw_augmentations(generator: torch.Generator, batch_size: int
                       ) -> Dict[str, torch.Tensor]:
    """Every random number ``apply_augmentations`` needs for a batch, drawn
    on the generator's device (see the module's docstring)."""
    b = batch_size
    return {"shrink": _shrink(generator, (b, 2)),
            "shift": _uniform(generator, (b, 2)),
            "contrast": _uniform(generator, (b,), *CONTRAST),
            "brightness": _uniform(generator, (b,), -BRIGHTNESS, BRIGHTNESS),
            "saturation": _uniform(generator, (b,), *SATURATION)}


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA contracts it into a fused
    multiply-add: the product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _weight_mat(input_size: int, output_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """jax.image's ``compute_weight_mat`` for the triangle kernel with
    antialiasing, per image: [B, input_size, output_size] float32 from
    ``scale`` and ``translation`` [B]."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out = torch.arange(output_size, dtype=torch.float32, device=dev) + 0.5
    # out * inv_scale - translation * inv_scale as one fused multiply-add,
    # as XLA compiles it (_fma)
    sample_f = _fma(out[None, :], inv_scale[:, None],
                    -(translation * inv_scale)[:, None]) - 0.5
    src = torch.arange(input_size, dtype=torch.float32, device=dev)
    x = (torch.abs(sample_f[:, None, :] - src[None, :, None])
         / kernel_scale[:, None, None])
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def _scale_and_translate(x: torch.Tensor, dims, scale: torch.Tensor,
                         translation: torch.Tensor) -> torch.Tensor:
    """``jax.image.scale_and_translate(x, x.shape, dims, scale,
    translation, "linear")`` for each image of the batch: ``x`` [B, ...],
    ``dims`` its two spatial dims (after the batch dim), ``scale`` and
    ``translation`` [B, 2]. Output shape = input shape."""
    (d0, d1) = dims
    w0 = _weight_mat(x.shape[d0], x.shape[d0], scale[:, 0],
                     translation[:, 0]).to(x.dtype)
    w1 = _weight_mat(x.shape[d1], x.shape[d1], scale[:, 1],
                     translation[:, 1]).to(x.dtype)
    # [B, ..., n0, ..., n1, ...] with the spatial dims moved last
    y = torch.movedim(x, (d0, d1), (-2, -1))
    lead = y.shape[1:-2]
    y = y.reshape(y.shape[0], -1, *y.shape[-2:])
    y = torch.einsum("bkhw,bhH,bwW->bkHW", y, w0, w1)
    y = y.reshape(y.shape[0], *lead, *y.shape[-2:])
    return torch.movedim(y, (-2, -1), (d0, d1))


def downsize_shift_pad(image: torch.Tensor, bbox: torch.Tensor,
                       shrink: torch.Tensor, shift: torch.Tensor,
                       masks: Optional[torch.Tensor] = None):
    """The shrink, shift and zero pad of a batch from its draws:
    ``image`` [B, H, W, 3], ``bbox`` [B, O, 4] COCO, ``shrink`` and
    ``shift`` [B, 2] (h, w); optional full-image ``masks`` [B, O, S, S]
    warped by the same affine and clipped to [0, 1]. Returns (image, bbox)
    or (image, bbox, masks)."""
    h, w = image.shape[1], image.shape[2]
    scale = 1.0 / shrink.to(image.device, torch.float32)  # <= 1
    off = shift.to(image.device, torch.float32) * (1.0 - scale)
    sizes = torch.tensor([h, w], dtype=torch.float32, device=image.device)
    out = _scale_and_translate(image, (1, 2), scale, off * sizes)
    # COCO [x, y, w, h]: x and w take the width factor, y and h the height
    new_bbox = torch.stack([
        _fma(bbox[..., 0], scale[:, 1:2], off[:, 1:2]),
        _fma(bbox[..., 1], scale[:, 0:1], off[:, 0:1]),
        bbox[..., 2] * scale[:, 1:2],
        bbox[..., 3] * scale[:, 0:1],
    ], dim=-1)
    if masks is None:
        return out, new_bbox
    s = masks.shape[-1]
    new_masks = _scale_and_translate(masks, (2, 3), scale, off * s)
    return out, new_bbox, torch.clamp(new_masks, 0.0, 1.0)


def _per_image(v: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    return v.to(image.device, image.dtype).reshape(-1, 1, 1, 1)


def contrast(image: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``(x - mean_hw) * f + mean_hw`` per image and channel
    (tf.image.random_contrast)."""
    mean = image.mean(dim=(1, 2), keepdim=True)
    return (image - mean) * _per_image(factor, image) + mean


def brightness(image: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``x + d`` per image."""
    return image + _per_image(delta, image)


def saturation(image: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """A blend with the image's grayscale: ``gray + f (x - gray)``."""
    gray = (GRAY[0] * image[..., 0] + GRAY[1] * image[..., 1]
            + GRAY[2] * image[..., 2])[..., None]
    return gray + _per_image(factor, image) * (image - gray)


def apply_augmentations(batch: Dict[str, torch.Tensor],
                        draws: Dict[str, torch.Tensor]) -> Dict:
    """The batch augmented with ``draws`` (``draw_augmentations``): the
    shrink, shift and pad of ``image``, ``bbox`` and, where the batch has
    them, ``masks`` [B, O, S, S], then contrast, brightness, saturation and
    a clip to [0, 1]. Other keys pass through."""
    out = dict(batch)
    moved = downsize_shift_pad(batch["image"], batch["bbox"],
                               draws["shrink"], draws["shift"],
                               batch.get("masks"))
    image, out["bbox"] = moved[:2]
    if "masks" in batch:
        out["masks"] = moved[2]
    image = contrast(image, draws["contrast"])
    image = brightness(image, draws["brightness"])
    image = saturation(image, draws["saturation"])
    out["image"] = torch.clamp(image, 0.0, 1.0)
    return out


def augment_batch(generator: torch.Generator,
                  batch: Dict[str, torch.Tensor]) -> Dict:
    """The batch augmented with fresh draws from ``generator``, on the
    batch's device: ``apply_augmentations(batch, draw_augmentations(...))``.
    """
    draws = draw_augmentations(generator, batch["image"].shape[0])
    return apply_augmentations(batch, draws)


# -- one image, as the JAX package's functions take it -----------------------


def random_downsize_shift_pad(generator: torch.Generator, image, bbox,
                              masks=None):
    """One image [H, W, 3], its boxes [O, 4] and optional masks [O, S, S]
    shrunk, shifted and padded with fresh draws."""
    out = downsize_shift_pad(
        image[None], bbox[None], _shrink(generator, (1, 2)),
        _uniform(generator, (1, 2)),
        None if masks is None else masks[None])
    return tuple(x[0] for x in out)


def random_contrast(generator: torch.Generator, image, lower=CONTRAST[0],
                    upper=CONTRAST[1]):
    return contrast(image[None], _uniform(generator, (1,), lower, upper))[0]


def random_brightness(generator: torch.Generator, image,
                      max_delta=BRIGHTNESS):
    return brightness(image[None],
                      _uniform(generator, (1,), -max_delta, max_delta))[0]


def random_saturation(generator: torch.Generator, image,
                      lower=SATURATION[0], upper=SATURATION[1]):
    return saturation(image[None], _uniform(generator, (1,), lower, upper))[0]


def augment_one(generator: torch.Generator, image, bbox, masks=None):
    """One image's augmentation: returns (image, bbox) or (image, bbox,
    masks)."""
    batch = {"image": image[None], "bbox": bbox[None]}
    if masks is not None:
        batch["masks"] = masks[None]
    out = augment_batch(generator, batch)
    keys = ("image", "bbox") + (("masks",) if masks is not None else ())
    return tuple(out[k][0] for k in keys)


# -- host-side extras ---------------------------------------------------------


def host_jpeg_quality(image: np.ndarray, rng, min_quality=70,
                      max_quality=100) -> np.ndarray:
    """Random JPEG re-encode of one image on the host (cv2, imported
    here)."""
    import cv2

    q = int(rng.integers(min_quality, max_quality + 1))
    u8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", u8[..., ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), q])
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
    return dec.astype(np.float32) / 255.0


def host_augment(batch: Dict[str, np.ndarray], rng) -> Dict[str, np.ndarray]:
    """The host pipeline's augmentation hook (``Pipeline.batches(augment=
    host_augment)``): the JPEG-quality step, which has no device form; the
    geometric and color steps run on the device."""
    images = batch["image"]
    batch = dict(batch)
    batch["image"] = np.stack(
        [host_jpeg_quality(im, rng) for im in images]).astype(np.float32)
    return batch
