"""TFRecord serialization round trip, the port's own copy.

Counterpart of boosted_detr_tpu/data/tfrecord.py: ``serialize_example``,
``write_tfrecords``, ``read_tfrecords`` and ``num_shards_needed`` write and
read the same files, so that either package reads what the other wrote:
(bbox, attribute, category, num_objects, image_id, raw image bytes) in
sharded TFRecord files. TensorFlow is used for the file format only and
is imported at the first call (``_tf``), never with the module.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence

import numpy as np


def _tf():
    import tensorflow as tf

    return tf


def serialize_example(bbox: np.ndarray, attribute: np.ndarray,
                      category: np.ndarray, num_objects: int, image_id: int,
                      image_bytes: bytes) -> bytes:
    """One example -> serialized tf.train.Example. Label tensors are
    stored as serialized tensors so ragged/object shapes survive."""
    tf = _tf()

    def tensor_feature(x):
        return tf.train.Feature(bytes_list=tf.train.BytesList(
            value=[tf.io.serialize_tensor(tf.constant(x)).numpy()]))

    def int_feature(x):
        return tf.train.Feature(int64_list=tf.train.Int64List(value=[int(x)]))

    feature = {
        "bbox": tensor_feature(np.asarray(bbox, np.float32)),
        "attribute": tensor_feature(np.asarray(attribute).astype(str)),
        "category": tensor_feature(np.asarray(category).astype(str)),
        "num_objects": int_feature(num_objects),
        "image_id": int_feature(image_id),
        "image": tf.train.Feature(bytes_list=tf.train.BytesList(
            value=[image_bytes])),
    }
    return tf.train.Example(
        features=tf.train.Features(feature=feature)).SerializeToString()


def write_tfrecords(df, image_loader, out_dir: str, files_per_shard: int,
                    name_qualifier: str = "data",
                    max_attribute_words: int = 8) -> List[str]:
    """Dataframe -> sharded .tfrecord files.

    ``image_loader(row) -> bytes`` supplies encoded image bytes (jpeg/png).
    """
    tf = _tf()
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    writer = None
    count = 0
    shard = 0
    for _, row in df.iterrows():
        if writer is None or count >= files_per_shard:
            if writer is not None:
                writer.close()
            path = os.path.join(out_dir,
                                f"{name_qualifier}_data_{shard}.tfrecord")
            writer = tf.io.TFRecordWriter(path)
            paths.append(path)
            shard += 1
            count = 0
        cats = [c[0] if isinstance(c, (list, tuple)) else c
                for c in row["category"]]
        atts = [(a if isinstance(a, (list, tuple)) else [a])[
            :max_attribute_words] for a in row["attribute"]]
        width = max((len(a) for a in atts), default=1)
        atts = [list(a) + ["<PAD>"] * (width - len(a)) for a in atts]
        writer.write(serialize_example(
            np.asarray(row["bbox"], np.float32), np.asarray(atts),
            np.asarray(cats), int(row["num_boxes"]), int(row["id_num"]),
            image_loader(row)))
        count += 1
    if writer is not None:
        writer.close()
    return paths


def read_tfrecords(paths: Sequence[str]) -> Iterator[Dict]:
    """Parse examples back. Yields dicts with decoded numpy labels and raw
    image bytes."""
    tf = _tf()
    desc = {
        "bbox": tf.io.FixedLenFeature([], tf.string),
        "attribute": tf.io.FixedLenFeature([], tf.string),
        "category": tf.io.FixedLenFeature([], tf.string),
        "num_objects": tf.io.FixedLenFeature([], tf.int64),
        "image_id": tf.io.FixedLenFeature([], tf.int64),
        "image": tf.io.FixedLenFeature([], tf.string),
    }
    for raw in tf.data.TFRecordDataset(list(paths)):
        ex = tf.io.parse_single_example(raw, desc)
        yield {
            "bbox": tf.io.parse_tensor(ex["bbox"], tf.float32).numpy(),
            "attribute": tf.io.parse_tensor(
                ex["attribute"], tf.string).numpy().astype(str),
            "category": tf.io.parse_tensor(
                ex["category"], tf.string).numpy().astype(str),
            "num_objects": int(ex["num_objects"].numpy()),
            "image_id": int(ex["image_id"].numpy()),
            "image_bytes": bytes(ex["image"].numpy()),
        }


def num_shards_needed(num_files: int, files_per_shard: int) -> int:
    """The shards ``num_files`` examples fill at ``files_per_shard``."""
    return -(-num_files // files_per_shard)
