"""Grain-based input pipeline, the port's own copy of
boosted_detr_tpu/data/grain_loader.py: a random-access source decodes the
image and encodes the labels of one record, grain's ``IndexSampler``
shuffles, repeats and shards records by process, and grain's worker pool
parallelises the host work. It yields the batch dicts of
``data.pipeline.Pipeline.batches``, as numpy arrays. grain is imported
inside ``make_grain_loader``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from boosted_detr_torch.data.pipeline import Pipeline, load_image


class DataFrameSource:
    """A grain RandomAccessDataSource over a COCO-format dataframe (or
    anything whose ``to_dict("records")`` gives its rows): decodes the image
    and encodes the labels of ONE record; grain batches downstream."""

    def __init__(self, df, pipeline: Pipeline):
        self._rows = df.to_dict("records")
        self._pipe = pipeline
        # one key set for the whole source, as Pipeline.batches decides it
        self._include_crowd = any(r.get("iscrowd") for r in self._rows)

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = self._rows[idx]
        batch = self._pipe._encode_labels(
            [row], include_crowd=self._include_crowd)
        image = load_image(row["image_path"], self._pipe.image_size,
                           self._pipe.dataset)
        out = {k: v[0] for k, v in batch.items()}
        out["image"] = image.astype(np.float32)
        out["image_id"] = np.int64(row.get("id_num", -1))
        return out


def make_grain_loader(df, pipeline: Pipeline, batch_size: int,
                      shuffle: bool = True, seed: int = 0,
                      num_epochs: Optional[int] = 1,
                      worker_count: int = 0,
                      process_index: int = 0, process_count: int = 1
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """A grain DataLoader over the dataframe, yielding framework batches.
    ``worker_count > 0`` prefetches in grain's worker processes;
    ``process_index``/``process_count`` shard the records by process."""
    import grain.python as grain

    source = DataFrameSource(df, pipeline)
    sampler = grain.IndexSampler(
        num_records=len(source),
        shard_options=grain.ShardOptions(shard_index=process_index,
                                         shard_count=process_count,
                                         drop_remainder=True),
        shuffle=shuffle,
        num_epochs=num_epochs,
        seed=seed)
    loader = grain.DataLoader(
        data_source=source,
        sampler=sampler,
        operations=[grain.Batch(batch_size=batch_size, drop_remainder=True)],
        worker_count=worker_count)
    return iter(loader)
