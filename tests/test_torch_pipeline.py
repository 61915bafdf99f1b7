"""The port's input pipeline (boosted_detr_torch/data/pipeline.py) against
the JAX package's on the same frames: ``Pipeline.batches`` bit for bit
(the same rows, seed and epoch; mask targets and crowd flags; process
strides), ``directory_batches`` and the native JPEG route on JPEG files
written here; and ``prefetch_to_device`` on the CPU (order, an error in
the producer raised in the consumer, the stop on close)."""

import threading

import numpy as np
import pandas as pd
import pytest
import torch

from boosted_detr_torch.data import codec as tcodec
from boosted_detr_torch.data import datasets as tds
from boosted_detr_torch.data import pipeline as tpipe
from boosted_detr_tpu.data import codec as jcodec
from boosted_detr_tpu.data import datasets as jds
from boosted_detr_tpu.data import pipeline as jpipe

torch.set_num_threads(2)


def _pipes(ds_args=dict(num_images=10, image_size=32, max_objects=3,
                        seed=4), **kw):
    ours_ds, ref_ds = tds.SyntheticShapes(**ds_args), jds.SyntheticShapes(
        **ds_args)
    df = ours_ds.dataframes("train")
    ref_ds.dataframes("train")
    vocab = ours_ds.get_vocab()
    ours = tpipe.Pipeline((32, 32), 4, tcodec.TextCodec(vocab),
                          dataset=ours_ds, **kw)
    ref = jpipe.Pipeline((32, 32), 4, jcodec.TextCodec(vocab),
                         dataset=ref_ds, **kw)
    return df, ours, ref


def _assert_batches_equal(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3, epoch=2),
    dict(shuffle=False, drop_remainder=False),
    dict(shuffle=True, seed=1, process_index=1, process_count=2),
    dict(shuffle=True, seed=5, repeat=False, epoch=0, process_index=0,
         process_count=2)])
def test_batches_match_jax(kw):
    df, ours, ref = _pipes()
    _assert_batches_equal(ours.batches(df, 3, **kw), ref.batches(df, 3, **kw))


def test_epoch_counter_advances_as_jax():
    df, ours, ref = _pipes()
    for _ in range(2):  # each call a fresh order
        _assert_batches_equal(ours.batches(df, 4), ref.batches(df, 4))


def test_masks_and_crowd_flags_match_jax():
    """Polygon, RLE and missing segmentation (a filled box) at mask size
    16, with crowd flags on some rows."""
    df, ours, ref = _pipes(mask_size=16)
    rows = df.to_dict("records")
    for i, r in enumerate(rows):
        n = r["num_boxes"]
        r["segmentation"] = [
            [[0.1, 0.1, 0.6, 0.1, 0.6, 0.7, 0.1, 0.7]],
            {"size": [16, 16], "counts": [20, 30, 206]}, None][:n]
        r["iscrowd"] = [int(i % 3 == 0)] + [0] * (n - 1)
        r["area"] = [50.0] * n
    df = pd.DataFrame(rows)
    _assert_batches_equal(ours.batches(df, 4, seed=2),
                          ref.batches(df, 4, seed=2))
    batch = next(ours.batches(df, 4, seed=2))
    assert batch["masks"].shape == (4, 4, 16, 16) and "iscrowd" in batch


def test_host_augment_hook_gets_the_epoch_stream():
    df, ours, ref = _pipes()

    def hook(batch, rng):
        return dict(batch, image=batch["image"] + rng.uniform())

    _assert_batches_equal(ours.batches(df, 4, augment=hook, epoch=1),
                          ref.batches(df, 4, augment=hook, epoch=1))


def test_too_few_rows_for_the_processes_raise():
    df, ours, _ = _pipes()
    with pytest.raises(ValueError, match="process_count"):
        next(ours.batches(df, 8, process_count=2))


def _jpegs(directory, n=5, size=(40, 30)):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        arr = (rng.uniform(0, 1, (*size, 3)) * 255).astype(np.uint8)
        path = directory / f"im{i}.jpg"
        Image.fromarray(arr).save(path, quality=90)
        paths.append(str(path))
    Image.fromarray(arr).save(directory / "extra.png")
    return paths


def test_native_jpeg_route_matches_jax(tmp_path):
    from boosted_detr_torch.native import imgload_binding as tload
    from boosted_detr_tpu.native import imgload_binding as jload

    paths = _jpegs(tmp_path) + [str(tmp_path / "extra.png")]
    ours, ok = tload.load_jpeg_batch(paths, (24, 20), num_threads=2)
    ref, ref_ok = jload.load_jpeg_batch(paths, (24, 20), num_threads=2)
    np.testing.assert_array_equal(ok, ref_ok)
    assert ok[:-1].all() and not ok[-1]  # a PNG is not the loader's
    np.testing.assert_array_equal(ours, ref)
    # the Pipeline's route: every row a JPEG
    rows = pd.DataFrame([{"image_path": p, "num_boxes": 0, "id_num": i}
                         for i, p in enumerate(paths[:-1])])
    vocab = {"category": ["a"], "attribute": ["b"]}
    a = tpipe.Pipeline((24, 20), 2, tcodec.TextCodec(vocab))
    b = jpipe.Pipeline((24, 20), 2, jcodec.TextCodec(vocab))
    _assert_batches_equal(a.batches(rows, 2, shuffle=False),
                          b.batches(rows, 2, shuffle=False))


def test_directory_batches_match_jax(tmp_path):
    _jpegs(tmp_path)
    vocab = {"category": ["a"], "attribute": ["b"]}
    ours = tpipe.Pipeline((16, 16), 2, tcodec.TextCodec(vocab))
    ref = jpipe.Pipeline((16, 16), 2, jcodec.TextCodec(vocab))
    _assert_batches_equal(ours.directory_batches(str(tmp_path), 4),
                          ref.directory_batches(str(tmp_path), 4))


def test_load_image_matches_jax(tmp_path):
    paths = _jpegs(tmp_path, n=1)
    for path in paths + [str(tmp_path / "extra.png")]:
        np.testing.assert_array_equal(tpipe.load_image(path, (20, 24)),
                                      jpipe.load_image(path, (20, 24)))
    with pytest.raises(ValueError, match="dataset"):
        tpipe.load_image("synthetic://train/0", (8, 8))
    assert tpipe.BOX_PAD_VALUE == jpipe.BOX_PAD_VALUE


def test_prefetch_keeps_order_and_values_on_the_cpu():
    df, ours, _ = _pipes()
    want = list(ours.batches(df, 3, epoch=0))
    got = list(tpipe.prefetch_to_device(ours.batches(df, 3, epoch=0),
                                        size=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in w.items():
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), v)
    # arrays of strings pass through as they are
    item = {"image_path": np.asarray(["a", "b"]), "x": torch.ones(2)}
    (out,) = tpipe.prefetch_to_device(iter([item]), device="cpu")
    assert out["image_path"] is item["image_path"] and out["x"] is item["x"]


def test_prefetch_raises_the_producers_error_in_the_consumer():
    def producer():
        yield {"x": np.zeros(2, np.float32)}
        raise KeyError("broken row")

    it = tpipe.prefetch_to_device(producer(), device="cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(KeyError, match="broken row"):
        next(it)


def test_prefetch_stops_its_thread_when_closed():
    def endless():
        while True:
            yield {"x": np.zeros(1, np.float32)}

    before = threading.active_count()
    it = tpipe.prefetch_to_device(endless(), size=1, device="cpu")
    next(it)
    it.close()
    assert threading.active_count() == before


def test_prefetch_with_a_sharding_is_not_ported():
    """A sharding other than ``batch_sharding`` is refused; on one rank the
    batch sharding's rows are the whole batch (several ranks:
    tests/test_torch_parallel_mesh.py)."""
    from boosted_detr_torch.parallel import mesh as mesh_lib

    with pytest.raises(TypeError, match="batch_sharding"):
        next(tpipe.prefetch_to_device(iter([]), sharding=object(),
                                      device="cpu"))
    mesh = mesh_lib.make_mesh(device="cpu")
    batch = {"image": np.arange(12, dtype=np.float32).reshape(4, 3)}
    got = next(tpipe.prefetch_to_device(
        iter([batch]), sharding=mesh_lib.batch_sharding(mesh)))
    assert isinstance(got, mesh_lib.ShardedBatch) and got.global_size == 4
    assert torch.equal(got["image"], torch.from_numpy(batch["image"]))
