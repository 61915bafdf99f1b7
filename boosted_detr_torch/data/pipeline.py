"""Host-side input pipeline: dataframe -> padded numpy batches -> device.

Counterpart of boosted_detr_tpu/data/pipeline.py: ``BOX_PAD_VALUE``,
``load_image`` (:44), ``Pipeline`` (:75-270: label encoding, mask targets
through ``data/masks.py``, the native JPEG route, ``batches`` with its
seed and epoch streams and per-process row strides, ``directory_batches``)
and ``prefetch_to_device`` (:272). The batches are the JAX package's bit
for bit, as numpy arrays: labels padded to static shapes (bbox pad -10.0,
string pad '<PAD>'), images float32 in [0, 1] resized to one size, string
labels turned into integer ids here by ``codec.TextCodec``.

``prefetch_to_device`` is where the port differs: a background thread
pins each batch in page-locked host memory and copies it to the card on a
stream of its own, so that the copy overlaps the step that runs on the
consumer's stream.

PIL, cv2 and requests are imported inside the functions that decode an
image, so the module imports with numpy and torch alone.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from boosted_detr_torch.config import PAD_TOKEN
from boosted_detr_torch.data.codec import TextCodec

BOX_PAD_VALUE = -10.0


def _scalar_or(value, default):
    """A scalar cell that may be missing or a pandas NaN -> value/default."""
    try:
        if value is None or not np.isfinite(value):
            return default
    except TypeError:
        return default
    return value


def load_image(path: str, image_size, dataset=None) -> np.ndarray:
    """Decode, resize and scale to [0, 1] float32. ``synthetic://`` paths
    render from a ``SyntheticShapes`` instance."""
    if path.startswith("synthetic://"):
        if dataset is None:
            raise ValueError("synthetic:// paths need the dataset")
        subset, idx = path[len("synthetic://"):].split("/")
        img = dataset.render(int(idx) + (0 if subset == "train" else 10_000))
    elif path.startswith(("http://", "https://")):
        import io

        import requests
        from PIL import Image

        r = requests.get(path, timeout=30)
        r.raise_for_status()
        with Image.open(io.BytesIO(r.content)) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    else:
        from PIL import Image

        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"), np.float32) / 255.0
    h, w = image_size
    if img.shape[:2] != (h, w):
        import cv2

        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(img.astype(np.float32), 0.0, 1.0)


def _is_local_jpeg(path: str) -> bool:
    return (path.lower().endswith((".jpg", ".jpeg"))
            and not path.startswith(("http://", "https://", "synthetic://")))


class Pipeline:
    """COCO-format dataframe -> batches of
    {image, category_ids, attribute_ids, bbox, num_objects, image_id,
    orig_size, area} (and ``iscrowd``, ``masks`` where asked for)."""

    def __init__(self, image_size, max_objects: int, codec: TextCodec,
                 max_attribute_words: int = 8, dataset=None,
                 mask_size: Optional[int] = None):
        self.image_size = tuple(image_size)
        self.max_objects = max_objects
        self.max_attribute_words = max_attribute_words
        self.codec = codec
        self.dataset = dataset  # for synthetic:// rendering
        self.mask_size = mask_size  # set -> batches carry 'masks' [B,O,S,S]
        self._epoch = 0  # advances per batches() call -> fresh shuffles

    def _encode_labels(self, rows,
                       include_crowd: bool = False) -> Dict[str, np.ndarray]:
        cats = [r.get("category") or [[PAD_TOKEN]] for r in rows]
        atts = [r.get("attribute") or [[PAD_TOKEN]] for r in rows]
        b = len(rows)
        o = self.max_objects
        bbox = np.full((b, o, 4), BOX_PAD_VALUE, np.float32)
        for i, r in enumerate(rows):
            boxes = r.get("bbox") or []
            for j, box in enumerate(boxes[:o]):
                bbox[i, j] = box
        out = {
            "category_ids": self.codec.encode_categories(cats, o),
            "attribute_ids": self.codec.encode_attributes(
                atts, o, self.max_attribute_words),
            "bbox": bbox,
            "num_objects": np.asarray(
                [min(int(r.get("num_boxes") or 0), o) for r in rows],
                np.int32),
        }
        # The original image size [h, w] and each object's area in pixels:
        # the COCO protocol's area ranges are defined on the original image,
        # from the annotation's own ``area`` where it has one.
        orig = np.zeros((b, 2), np.int32)
        area = np.zeros((b, o), np.float32)
        for i, r in enumerate(rows):
            ih = int(_scalar_or(r.get("height"), 0)) or self.image_size[0]
            iw = int(_scalar_or(r.get("width"), 0)) or self.image_size[1]
            orig[i] = (ih, iw)
            boxes = r.get("bbox") or []
            areas = r.get("area")
            areas = areas if isinstance(areas, (list, tuple)) else []
            for j in range(min(len(boxes), o)):
                a = areas[j] if j < len(areas) else None
                if a is not None and np.isfinite(a) and a > 0:
                    area[i, j] = float(a)
                else:
                    area[i, j] = max(boxes[j][2], 0.0) * max(
                        boxes[j][3], 0.0) * iw * ih
        out["orig_size"] = orig
        out["area"] = area
        if include_crowd:
            # decided once per feed, so that every batch of one iterator has
            # the same keys (grouped steps stack them)
            crowd = np.zeros((b, o), np.int32)
            for i, r in enumerate(rows):
                flags = r.get("iscrowd")  # pandas NaN when the row lacks it
                if not isinstance(flags, (list, tuple)):
                    continue
                for j, flag in enumerate(flags[:o]):
                    crowd[i, j] = int(flag or 0)
            out["iscrowd"] = crowd
        if self.mask_size:
            out["masks"] = self._encode_masks(rows, bbox)
        return out

    def _encode_masks(self, rows, bbox: np.ndarray) -> np.ndarray:
        """Panoptic mask targets [B, O, S, S] from the ``segmentation``
        column (polygons or RLE, ``data/masks.py``); objects without one
        get filled-box masks."""
        from boosted_detr_torch.data import masks as masks_lib

        b, o = len(rows), self.max_objects
        s = self.mask_size
        out = np.zeros((b, o, s, s), np.float32)
        for i, r in enumerate(rows):
            segs = r.get("segmentation") or []
            n = min(int(r.get("num_boxes") or 0), o)
            for j in range(n):
                seg = segs[j] if j < len(segs) else None
                out[i, j] = masks_lib.segmentation_to_mask(
                    seg, s, bbox=bbox[i, j])
        return out

    def _load_images(self, chunk) -> np.ndarray:
        """A batch of images. Local JPEG files take the native loader
        (native/imgload: libjpeg decode, bilinear resize, a thread pool),
        and a file it cannot decode goes through ``load_image``; every
        other path, or a host where the loader does not build, takes
        ``load_image`` for each image."""
        paths = [r["image_path"] for r in chunk]
        if all(_is_local_jpeg(p) for p in paths):
            from boosted_detr_torch.native import imgload_binding

            try:
                images, ok = imgload_binding.load_jpeg_batch(
                    paths, self.image_size)
            except (RuntimeError, OSError):
                pass  # g++ or libjpeg missing on this host
            else:
                for i in np.nonzero(~ok)[0]:
                    images[i] = load_image(paths[i], self.image_size,
                                           self.dataset)
                return images
        return np.stack([
            load_image(p, self.image_size, self.dataset) for p in paths])

    def batches(self, df, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_remainder: bool = True,
                augment=None, repeat: bool = False,
                process_index: int = 0, process_count: int = 1,
                epoch: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield padded numpy batches. ``df`` is a dataframe, or anything
        whose ``to_dict("records")`` gives its rows. ``augment`` is an
        optional host-side callable(batch_dict, rng) -> batch_dict.

        When ``shuffle``, each call draws a fresh order and augmentation
        stream (``seed`` with an advancing per-pipeline epoch counter); pass
        ``epoch`` for a given epoch's stream.

        Several processes: pass ``process_index``/``process_count`` and each
        reads its own row stride of one shared permutation; every process
        yields the same number of batches."""
        if epoch is None:
            epoch, self._epoch = self._epoch, self._epoch + 1
        rng = np.random.default_rng((seed, epoch) if shuffle else seed)
        rows = df.to_dict("records")
        include_crowd = any(r.get("iscrowd") for r in rows)  # once per feed
        if process_count > 1 and len(rows) < batch_size * process_count:
            raise ValueError(
                f"dataset has {len(rows)} rows but one global batch needs "
                f"batch_size*process_count = {batch_size * process_count}; "
                "shrink batch_size or grow the dataset")
        while True:
            # the permutation is the same on every process; truncating after
            # it rotates the excluded remainder across epochs
            order = rng.permutation(len(rows)) if shuffle else np.arange(
                len(rows))
            if process_count > 1:
                per = len(rows) // (batch_size * process_count)
                order = order[:per * batch_size * process_count]
                order = order[process_index::process_count]
            for start in range(0, len(order), batch_size):
                idx = order[start:start + batch_size]
                if len(idx) < batch_size and drop_remainder:
                    continue
                chunk = [rows[i] for i in idx]
                batch = self._encode_labels(chunk,
                                            include_crowd=include_crowd)
                batch["image"] = self._load_images(chunk)
                batch["image_id"] = np.asarray(
                    [int(r.get("id_num", -1)) for r in chunk], np.int64)
                if augment is not None:
                    batch = augment(batch, rng)
                yield batch
            if not repeat:
                break

    def directory_batches(self, directory: str, batch_size: int
                          ) -> Iterator[Dict[str, np.ndarray]]:
        """Unlabeled inference feed from an image directory, with
        placeholder labels."""
        paths = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".gif", ".bmp")))
        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            rows = [{"bbox": None, "category": None, "attribute": None,
                     "num_boxes": 0, "id_num": start + i}
                    for i in range(len(chunk))]
            batch = self._encode_labels(rows)
            batch["image"] = np.stack(
                [load_image(p, self.image_size) for p in chunk])
            batch["image_path"] = np.asarray(chunk)
            yield batch


def _to_tensor(value, device: torch.device, stream):
    """One batch entry on ``device``: a numeric numpy array or a CPU tensor
    is copied (through pinned memory and ``stream`` to a card), a tensor
    already on ``device`` stays where it is, anything else (an array of
    paths) passes through."""
    if isinstance(value, np.ndarray):
        if value.dtype.kind not in "biuf":
            return value
        value = torch.from_numpy(np.ascontiguousarray(value))
    if not isinstance(value, torch.Tensor) or value.device == device:
        return value
    if stream is None:
        return value.to(device)
    with torch.cuda.stream(stream):
        return value.pin_memory().to(device, non_blocking=True)


_END = object()


def prefetch_to_device(iterator, size: int = 2, sharding=None,
                       device=None) -> Iterator[Dict]:
    """Yield the batches of ``iterator`` with their numeric entries as
    tensors on ``device`` (``cuda`` unless the caller passes another),
    prepared up to ``size`` batches ahead by a background thread.

    On a card the thread pins each entry in page-locked host memory and
    copies it on a side stream, then records an event; the consumer's
    stream waits on that event before the batch is handed over, and every
    tensor is ``record_stream``ed on the consumer's stream, so that the
    caching allocator does not reuse its memory while the consumer's work
    is queued. An exception raised by the iterator is raised here, in the
    consumer. Closing the generator stops the thread.

    ``sharding=mesh.batch_sharding(mesh)``: each batch of ``iterator`` is
    the global batch, and this rank's rows of it are copied (on the same
    pinned side-stream route), as a ``mesh.ShardedBatch`` the Trainer
    takes as it is; the device is then the mesh's unless ``device`` names
    one."""
    from boosted_detr_torch.models.detr import _resolve_device
    from boosted_detr_torch.parallel import mesh as mesh_lib

    if sharding is not None:
        if not isinstance(sharding, mesh_lib.BatchSharding):
            raise TypeError("prefetch_to_device takes sharding="
                            "mesh.batch_sharding(mesh), not "
                            f"{type(sharding).__name__}")
        device = sharding.mesh.device if device is None else device
    device = _resolve_device(device)
    on_card = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        stream = torch.cuda.Stream(device) if on_card else None
        try:
            for item in iterator:
                if sharding is not None:
                    n = len(next(iter(item.values())))
                    rows = sharding.rows(n)
                    moved = mesh_lib.ShardedBatch(
                        {k: _to_tensor(v[rows], device, stream)
                         for k, v in item.items()}, n)
                else:
                    moved = {k: _to_tensor(v, device, stream)
                             for k, v in item.items()}
                event = None
                if on_card:
                    event = torch.cuda.Event()
                    event.record(stream)
                if not put((moved, event, None)):
                    return
            put(_END)
        except BaseException as exc:  # raised again in the consumer
            put((None, None, exc))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            batch, event, exc = item
            if exc is not None:
                raise exc
            if on_card:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        v.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
