"""The port's native LAP binding, TFRecord files, grain loader and
visualisation helpers (boosted_detr_torch/native/, data/tfrecord.py,
data/grain_loader.py, utils/visualize.py) against the JAX package's on the
same inputs, bit for bit: nothing here draws random bits."""

import pathlib

import numpy as np
import pytest
import scipy.optimize
import torch

from boosted_detr_torch import native as tnative
from boosted_detr_torch.data import codec as tcodec
from boosted_detr_torch.data import datasets as tds
from boosted_detr_torch.data import grain_loader as tgrain
from boosted_detr_torch.data import pipeline as tpipe
from boosted_detr_torch.data import tfrecord as ttf
from boosted_detr_torch.native import lap_binding as tlap
from boosted_detr_tpu.data import codec as jcodec
from boosted_detr_tpu.data import datasets as jds
from boosted_detr_tpu.data import grain_loader as jgrain
from boosted_detr_tpu.data import pipeline as jpipe
from boosted_detr_tpu.data import tfrecord as jtf
from boosted_detr_tpu.native import lap_binding as jlap

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["lap/lap.cpp", "imgload/imgload.cpp"])
def test_native_sources_are_copies(name):
    ours = (ROOT / "boosted_detr_torch" / "native" / name).read_bytes()
    assert ours == (ROOT / "boosted_detr_tpu" / "native" / name).read_bytes()


def test_lap_matches_jax_binding_and_scipy():
    rng = np.random.default_rng(0)
    cost = rng.uniform(0, 1, (6, 12, 20)).astype(np.float32)
    cost[1] = np.round(cost[1] * 4) / 4  # ties
    n = np.asarray([12, 0, 5, 1, 12, 7], np.int32)
    ours = tlap.lap_solve_batch(cost, n)
    np.testing.assert_array_equal(ours, jlap.lap_solve_batch(cost, n))
    total = 0.0
    for i in range(6):
        rows, cols = scipy.optimize.linear_sum_assignment(cost[i, :n[i]])
        total += float(cost[i, rows, cols].sum())
        np.testing.assert_array_equal(ours[i].sum(-1)[:n[i]], 1)
        assert ours[i, n[i]:].sum() == 0
        assert np.isclose((ours[i] * cost[i]).sum(),
                          cost[i, rows, cols].sum(), rtol=1e-6)
    assert tlap.lap_total_cost(cost, n) == jlap.lap_total_cost(cost, n)
    assert np.isclose(tlap.lap_total_cost(cost, n), total, rtol=1e-6)
    with pytest.raises(ValueError, match="num_objects"):
        tlap.lap_solve_batch(cost, np.full(6, 13, np.int32))


def test_native_libraries_build_under_build_native():
    tlap.load()
    path = tnative.library_path(tnative.HERE / "lap" / "lap.cpp")
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert not list((ROOT / "boosted_detr_torch").rglob("*.so"))


def _frame(n=5):
    ds = tds.SyntheticShapes(num_images=n, image_size=16, max_objects=3,
                             seed=2)
    return ds, ds.dataframes("train")


def _image_bytes(row):
    return f"bytes of {row['image_path']}".encode()


@pytest.mark.parametrize("writer,reader", [(ttf, jtf), (jtf, ttf)])
def test_tfrecords_written_by_one_package_read_by_the_other(tmp_path, writer,
                                                            reader):
    _, df = _frame()
    paths = writer.write_tfrecords(df, _image_bytes, str(tmp_path), 2,
                                   name_qualifier="train")
    assert len(paths) == writer.num_shards_needed(len(df), 2) == 3
    assert ([p.rsplit("/", 1)[1] for p in paths]
            == [p.rsplit("/", 1)[1] for p in jtf.write_tfrecords(
                df, _image_bytes, str(tmp_path / "ref"), 2,
                name_qualifier="train")])
    got = list(reader.read_tfrecords(paths))
    assert len(got) == len(df)
    for ex, (_, row) in zip(got, df.iterrows()):
        np.testing.assert_array_equal(ex["bbox"],
                                      np.asarray(row["bbox"], np.float32))
        assert list(ex["category"]) == [c[0] for c in row["category"]]
        assert ex["attribute"].tolist() == row["attribute"]
        assert (ex["num_objects"], ex["image_id"]) == (row["num_boxes"],
                                                       row["id_num"])
        assert ex["image_bytes"] == _image_bytes(row)
    one = dict(bbox=np.ones((2, 4), np.float32),
               attribute=np.asarray([["a", "<PAD>"], ["b", "c"]]),
               category=np.asarray(["x", "y"]), num_objects=2, image_id=7,
               image_bytes=b"\x00\x01")
    assert ttf.serialize_example(**one) == jtf.serialize_example(**one)


def test_grain_loader_matches_jax():
    ds, df = _frame(n=8)
    ref_ds = jds.SyntheticShapes(num_images=8, image_size=16, max_objects=3,
                                 seed=2)
    ref_ds.dataframes("train")
    vocab = ds.get_vocab()
    ours = tgrain.make_grain_loader(
        df, tpipe.Pipeline((16, 16), 3, tcodec.TextCodec(vocab), dataset=ds),
        batch_size=3, seed=1)
    ref = jgrain.make_grain_loader(
        df, jpipe.Pipeline((16, 16), 3, jcodec.TextCodec(vocab),
                           dataset=ref_ds), batch_size=3, seed=1)
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_visualize_smoke(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from boosted_detr_torch.utils import visualize

    ds, df = _frame(n=2)
    codec = tcodec.TextCodec(ds.get_vocab())
    batch = next(tpipe.Pipeline((16, 16), 3, codec, dataset=ds).batches(
        df, 2, shuffle=False))
    ax = visualize.show_example(batch["image"][0], batch, 0, codec,
                                save_path=str(tmp_path / "gt.png"))
    assert len(ax.patches) == batch["num_objects"][0]
    ax = visualize.show_prediction(
        batch["image"][1], ["red", "<PAD>", "blue"], ["small", "", "wide"],
        np.asarray([[0.1, 0.1, 0.3, 0.3]] * 3),
        save_path=str(tmp_path / "pred.png"))
    assert len(ax.patches) == 2  # the <PAD> slot is left out
    assert (tmp_path / "gt.png").exists() and (tmp_path / "pred.png").exists()
