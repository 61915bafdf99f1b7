"""The port's copies of the dataset loaders and the config helpers
(boosted_detr_torch/data/datasets.py, config.py's ``Filepaths``,
``from_yaml`` and ``default_params``) against the JAX package's, on the
same inputs. Neither side draws random bits the other cannot (the
procedural ``SyntheticShapes`` draws from numpy), so every comparison is
exact: frames with ``pandas.testing.assert_frame_equal``, images with
``assert_array_equal``."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

import boosted_detr_torch as bt
from boosted_detr_torch import config as tconfig
from boosted_detr_torch.data import datasets as tds
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.data import datasets as jds


def _coco(tmp_path, n_images=3):
    """A small COCO-format instance file with every optional column:
    polygons and an RLE crowd, attributes, keypoints, areas, a DensePose
    pass-through key, and a captions file."""
    images = [{"id": 10 + i, "file_name": f"im{i}.jpg", "width": 64 + 8 * i,
               "height": 48 + 4 * i} for i in range(n_images)]
    anns = []
    for i in range(n_images):
        for j in range(i + 1):
            ann = {"id": len(anns), "image_id": 10 + i, "category_id": 1 + j,
                   "bbox": [2.0 + j, 3.0, 10.0 + i, 12.0 - j],
                   "segmentation": [[2, 3, 12, 3, 12, 15, 2, 15]],
                   "area": 100.0 + j, "iscrowd": 0,
                   "keypoints": [5, 6, 2, 7, 8, 1],
                   "num_keypoints": 2}
            if j == 1:
                ann["attribute_ids"] = [1, 2]
                ann["segmentation"] = {"size": [48, 64],
                                       "counts": [100, 20, 3000]}
                ann["iscrowd"] = 1
                ann["dp_I"] = [1, 2]
                del ann["area"]
            anns.append(ann)
    info = {"images": images, "annotations": anns,
            "categories": [{"id": k, "name": f"cat{k}"} for k in (1, 2, 3)],
            "attributes": [{"id": k, "name": f"att{k}"} for k in (1, 2)]}
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(info))
    caps = {"annotations": [{"image_id": 10, "caption": "a thing"},
                            {"image_id": 11, "caption": "two things"},
                            {"image_id": 10, "caption": "again"}]}
    cap_path = tmp_path / "captions.json"
    cap_path.write_text(json.dumps(caps))
    return str(path), str(cap_path)


@pytest.mark.parametrize("segmentation,keypoints", [(True, True),
                                                    (False, False)])
def test_coco_json_to_dataframe_matches_jax(tmp_path, segmentation,
                                            keypoints):
    path, caps = _coco(tmp_path)
    kw = dict(include_segmentation=segmentation,
              include_keypoints=keypoints, captions_json_path=caps)
    ours = tds.coco_json_to_dataframe(path, "/data/images", **kw)
    ref = jds.coco_json_to_dataframe(path, "/data/images", **kw)
    pd.testing.assert_frame_equal(ours, ref)
    assert "caption" in ours and "dp_I" in ours
    assert ("segmentation" in ours) == segmentation


def test_coco_cache_round_trip_matches_jax(tmp_path):
    path, _ = _coco(tmp_path)
    for pkg, name in ((tds, "ours"), (jds, "ref")):
        cache = str(tmp_path / name / "cache.json")
        first = pkg.coco_json_to_dataframe(path, "/img", cache_path=cache)
        assert os.path.exists(cache)
        again = pkg.coco_json_to_dataframe(path, "/img", cache_path=cache)
        assert list(again.columns) == list(first.columns)
    pd.testing.assert_frame_equal(
        tds.coco_json_to_dataframe(
            path, "/img", cache_path=str(tmp_path / "ours/cache.json")),
        jds.coco_json_to_dataframe(
            path, "/img", cache_path=str(tmp_path / "ref/cache.json")))


def test_coco_loaders_read_a_local_layout_as_jax_does(tmp_path):
    """COCOStandard and Fashionpedia on files already in place (no
    download): the same frames, vocabularies and object counts."""
    path, caps = _coco(tmp_path)
    local = tmp_path / "local"
    (local / "annotations").mkdir(parents=True)
    shutil.copy(path, local / "annotations" / "instances_val2017.json")
    shutil.copy(caps, local / "annotations" / "captions_val2017.json")
    loaded = {}
    for name, pkg in (("ours", tds), ("ref", jds)):
        archive = tmp_path / name  # each side's own cache
        archive.mkdir()
        shutil.copy(path, archive / "instances_attributes_train2020.json")
        coco = pkg.COCOStandard(str(archive), str(local))
        fash = pkg.Fashionpedia(str(archive), str(local))
        loaded[name] = [(coco, coco.dataframes("val")),
                        (fash, fash.dataframes("train"))]
    for (ours, ours_df), (ref, ref_df) in zip(loaded["ours"], loaded["ref"]):
        pd.testing.assert_frame_equal(ours_df, ref_df)
        assert ours.get_vocab() == ref.get_vocab()
        assert ours.max_num_obj() == ref.max_num_obj()
        assert ours.citation() == ref.citation()


def test_unsplash_and_clothing_loaders_match_jax(tmp_path):
    pd.DataFrame({"photo_id": ["a", "b", "c"],
                  "photo_image_url": ["u1", "u2", "u3"],
                  "photo_width": [10, 20, 30],
                  "photo_height": [5, 6, 7]}).to_csv(
        tmp_path / "photos.tsv000", sep="\t", index=False)
    pd.DataFrame({"photo_id": ["a", "a", "c"],
                  "keyword": ["sky", "blue", "tree"]}).to_csv(
        tmp_path / "keywords.tsv000", sep="\t", index=False)
    repo = tmp_path / "clothing-dataset"
    repo.mkdir()
    pd.DataFrame({"image": ["x1", "x2", "x3"], "sender_id": [1, 2, 3],
                  "label": ["Shirt", "Not sure", "Hat"],
                  "kids": [False, False, True]}).to_csv(
        repo / "images.csv", index=False)
    for ours_cls, ref_cls in ((tds.UnsplashLite, jds.UnsplashLite),
                              (tds.ClothingDatasetGrigorev,
                               jds.ClothingDatasetGrigorev)):
        ours = ours_cls(str(tmp_path), str(tmp_path)).dataframes()
        ref = ref_cls(str(tmp_path), str(tmp_path)).dataframes()
        pd.testing.assert_frame_equal(ours, ref)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("preset", ["easy", "hard"])
def test_synthetic_shapes_rows_and_images_match_jax(seed, preset):
    kw = dict(num_images=5, image_size=64, num_val_images=3, seed=seed)
    if preset == "hard":
        ours, ref = tds.SyntheticShapes.hard(**kw), jds.SyntheticShapes.hard(
            **kw)
    else:
        ours = tds.SyntheticShapes(max_objects=4, **kw)
        ref = jds.SyntheticShapes(max_objects=4, **kw)
    for subset in ("train", "val"):
        pd.testing.assert_frame_equal(ours.dataframes(subset),
                                      ref.dataframes(subset))
        for i in ours.dataframes(subset)["id_num"]:
            np.testing.assert_array_equal(ours.render(i), ref.render(i))
    assert ours.get_vocab() == ref.get_vocab()
    assert ours.max_num_obj() == ref.max_num_obj()


def test_synthetic_rows_need_no_pandas():
    """``rows`` gives the frame's rows as ``dataframes`` builds them."""
    ds = tds.SyntheticShapes(num_images=4, image_size=32, seed=3)
    rows = ds.rows("train")
    assert rows == ds.dataframes("train").to_dict("records")
    assert ds.rows("val")[0]["id_num"] == 10_000


def test_loaders_need_dataframes_first():
    ds = tds.SyntheticShapes(num_images=2, image_size=16)
    with pytest.raises(RuntimeError, match="dataframes"):
        ds.max_num_obj()


def test_filepaths_match_jax():
    ours, ref = tconfig.Filepaths(), jconfig.Filepaths()
    assert ours.default_params() == ref.default_params()
    assert (ours.default_params("checkpoint_save_dir")
            == ref.default_params("checkpoint_save_dir"))


def test_from_yaml_with_dotted_overrides_matches_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("model:\n  encoder_dim: 128\n  image_size: [320, 320]\n"
                    "train:\n  batch_size: 4\n  loss_weights:\n"
                    "    category: 10.0\n    box: 2.0\n")
    over = {"model.num_decoder_blocks": 2, "train.learning_rate": 0.01}
    ours = bt.from_yaml(str(path), **over)
    ref = jconfig.from_yaml(str(path), **over)
    for o, r in zip(ours, ref):
        assert dataclasses.asdict(o) == dataclasses.asdict(r)
    assert ours[0].image_size == (320, 320)
    assert ours[1].loss_weights.category == 10.0
    with pytest.raises(KeyError, match="model./train."):
        bt.from_yaml(str(path), **{"optim.lr": 1})


@pytest.mark.parametrize("name", ["COCO", "Fashionpedia"])
def test_default_params_match_jax(name):
    ours = bt.default_params(name, decoder_dim=128)
    ref = jconfig.default_params(name, decoder_dim=128)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
