"""Dataset acquisition and ETL, the port's own copy.

Counterpart of boosted_detr_tpu/data/datasets.py: ``DatasetLoader`` (the
download and unzip scaffolding), ``coco_json_to_dataframe`` (:87),
``COCOStandard``, ``Fashionpedia``, ``UnsplashLite``, ``SyntheticShapes``
(:293, with ``hard()`` at :336) and ``ClothingDatasetGrigorev``, with the
same names, the same dataframe contract and the same numbers. pandas is
imported inside the functions that build a dataframe, so the module
imports with numpy alone, and ``SyntheticShapes.rows`` gives the rows of
``dataframes`` as a list of dicts to a caller without pandas.

The dataframe contract (consumed by ``data.pipeline.Pipeline``):
  - ``image_path`` str, ``id_num`` int, ``width``/``height`` int
  - ``num_boxes`` int
  - ``bbox``: list of [xmin, ymin, w, h] normalized to [0,1] (COCO format)
  - ``category``: list of [name] per object (string labels)
  - ``attribute``: list of [name, ...] per object, ['<PAD>'] when missing

``SyntheticShapes`` draws colored rectangles with exactly derivable labels
from ``numpy.random.default_rng(seed)``: its rows and images are those of
the JAX package bit for bit. No network is needed for it.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, List, Optional

import numpy as np

from boosted_detr_torch.config import PAD_TOKEN


class DatasetLoader:
    """Download/unzip scaffolding. Idempotent: existing files are not
    re-fetched."""

    urls: Dict[str, str] = {}

    def __init__(self, archive_base_dir: str, local_base_dir: str):
        self.archive_base_dir = archive_base_dir
        self.local_base_dir = local_base_dir
        self._df = None

    def get_data(self, download: bool = True, unzip: bool = True) -> None:
        os.makedirs(self.archive_base_dir, exist_ok=True)
        os.makedirs(self.local_base_dir, exist_ok=True)
        for name, url in self.urls.items():
            archive = os.path.join(self.archive_base_dir, name)
            if download and not os.path.exists(archive):
                self._download(url, archive)
            if unzip and archive.endswith(".zip") and os.path.exists(archive):
                marker = archive + ".extracted"
                if not os.path.exists(marker):
                    with zipfile.ZipFile(archive) as zf:
                        zf.extractall(self.local_base_dir)
                    open(marker, "w").close()

    @staticmethod
    def _download(url: str, dest: str) -> None:
        import requests

        with requests.get(url, stream=True, timeout=60) as r:
            r.raise_for_status()
            with open(dest, "wb") as f:
                for chunk in r.iter_content(1 << 20):
                    f.write(chunk)

    # -- surface parity helpers --
    def max_num_obj(self) -> int:
        if self._df is None:
            raise RuntimeError("call dataframes() first")
        return int(self._df["num_boxes"].max())

    def get_vocab(self) -> Dict[str, List[str]]:
        if self._df is None:
            raise RuntimeError("call dataframes() first")
        cats = {w for row in self._df["category"] for obj in row for w in
                (obj if isinstance(obj, list) else [obj])}
        atts = {w for row in self._df["attribute"] for obj in row for w in
                (obj if isinstance(obj, list) else [obj])}
        atts.discard(PAD_TOKEN)
        return {"category": sorted(cats), "attribute": sorted(atts)}

    def citation(self) -> str:
        return ""


# Per-object pass-through columns, emitted only when any annotation carries
# the key.
_PASSTHROUGH = ("segments_info", "dp_I", "dp_U", "dp_V", "dp_x", "dp_y",
                "dp_masks")


def coco_json_to_dataframe(json_path: str, image_dir: str,
                           cache_path: Optional[str] = None,
                           include_segmentation: bool = True,
                           include_keypoints: bool = True,
                           captions_json_path: Optional[str] = None):
    """COCO-format instance JSON -> per-image dataframe: string labels,
    normalized boxes, <PAD>-filled attributes, cached to JSON.

    Optional columns, as the JAX package's (datasets.py:97-121):
    ``segmentation`` (normalized polygons or a raw RLE dict) and
    ``iscrowd``; ``keypoints`` (normalized flat [x, y, v, ...]) and
    ``num_keypoints``; ``caption`` from ``captions_json_path``; ``area`` in
    pixels; and the pass-through ``segments_info`` and DensePose columns
    where the annotations carry them. A cache that lacks the optional
    columns asked for is rebuilt."""
    import pandas as pd

    if cache_path and os.path.exists(cache_path):
        cached = pd.read_json(cache_path)
        expected = {"area"} \
            | ({"segmentation", "iscrowd"} if include_segmentation
               else set()) \
            | ({"keypoints", "num_keypoints"} if include_keypoints
               else set())
        if expected <= set(cached.columns):
            return cached

    with open(json_path) as f:
        info = json.load(f)

    cat_names = {c["id"]: c["name"] for c in info.get("categories", [])}
    att_names = {a["id"]: a["name"] for a in info.get("attributes", [])}
    images = {im["id"]: im for im in info["images"]}

    seen_keys = set()
    for ann in info["annotations"]:
        seen_keys.update(ann.keys())
    passthrough = [k for k in _PASSTHROUGH if k in seen_keys]

    rows: Dict[int, Dict] = {}
    for ann in info["annotations"]:
        img = images[ann["image_id"]]
        row = rows.setdefault(ann["image_id"], {
            "id_num": ann["image_id"],
            "file_name": img["file_name"],
            "image_path": os.path.join(image_dir, img["file_name"]),
            "width": img["width"], "height": img["height"],
            "num_boxes": 0, "bbox": [], "category": [], "attribute": [],
            "area": [],
            **({"segmentation": [], "iscrowd": []}
               if include_segmentation else {}),
            **({"keypoints": [], "num_keypoints": []}
               if include_keypoints else {}),
            **{k: [] for k in passthrough},
        })
        x, y, w, h = ann["bbox"]
        iw, ih = img["width"], img["height"]
        row["bbox"].append([x / iw, y / ih, w / iw, h / ih])
        row["category"].append([cat_names.get(ann.get("category_id"),
                                              PAD_TOKEN)])
        att_ids = ann.get("attribute_ids", [])
        row["attribute"].append(
            [att_names[i] for i in att_ids] if att_ids else [PAD_TOKEN])
        if include_segmentation:
            seg = ann.get("segmentation")
            if isinstance(seg, list):  # polygons -> normalize to [0, 1]
                seg = [[v / (iw if i % 2 == 0 else ih)
                        for i, v in enumerate(ring)] for ring in seg]
            row["segmentation"].append(seg)
            row["iscrowd"].append(int(ann.get("iscrowd", 0)))
        if include_keypoints:
            kps = ann.get("keypoints") or []
            row["keypoints"].append(
                [(v / iw if i % 3 == 0 else v / ih if i % 3 == 1 else v)
                 for i, v in enumerate(kps)])
            row["num_keypoints"].append(int(ann.get("num_keypoints", 0)))
        row["area"].append(float(ann.get("area", w * h)))
        for k in passthrough:
            row[k].append(ann.get(k))
        row["num_boxes"] += 1

    df = pd.DataFrame.from_dict(rows, orient="index").reset_index(drop=True)
    if captions_json_path and os.path.exists(captions_json_path):
        with open(captions_json_path) as f:
            cap_info = json.load(f)
        caps: Dict[int, List[str]] = {}
        for ann in cap_info.get("annotations", []):
            caps.setdefault(ann["image_id"], []).append(ann["caption"])
        df["caption"] = [caps.get(i, []) for i in df["id_num"]]
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        df.to_json(cache_path)
    return df


class COCOStandard(DatasetLoader):
    """COCO 2017."""

    urls = {
        "train2017.zip": "http://images.cocodataset.org/zips/train2017.zip",
        "val2017.zip": "http://images.cocodataset.org/zips/val2017.zip",
        "annotations_trainval2017.zip":
            "http://images.cocodataset.org/annotations/"
            "annotations_trainval2017.zip",
    }

    def dataframes(self, subset: str = "train"):
        name = {"train": "train2017", "val": "val2017"}[subset]
        json_path = os.path.join(self.local_base_dir, "annotations",
                                 f"instances_{name}.json")
        image_dir = os.path.join(self.local_base_dir, name)
        cache = os.path.join(self.archive_base_dir,
                             f"{name}_combined_annotations_df.json")
        self._df = coco_json_to_dataframe(
            json_path, image_dir, cache,
            captions_json_path=os.path.join(self.local_base_dir,
                                            "annotations",
                                            f"captions_{name}.json"))
        return self._df

    def citation(self) -> str:
        return ("Lin et al., 'Microsoft COCO: Common Objects in Context', "
                "ECCV 2014. https://cocodataset.org")


class Fashionpedia(DatasetLoader):
    """Fashionpedia (categories and fine-grained attributes)."""

    urls = {
        "train2020.zip": "https://s3.amazonaws.com/ifashionist-dataset/"
                         "images/train2020.zip",
        "val_test2020.zip": "https://s3.amazonaws.com/ifashionist-dataset/"
                            "images/val_test2020.zip",
        "instances_attributes_train2020.json":
            "https://s3.amazonaws.com/ifashionist-dataset/annotations/"
            "instances_attributes_train2020.json",
        "instances_attributes_val2020.json":
            "https://s3.amazonaws.com/ifashionist-dataset/annotations/"
            "instances_attributes_val2020.json",
    }

    def dataframes(self, subset: str = "train"):
        name = {"train": "train", "val": "test"}[subset]
        json_path = os.path.join(
            self.archive_base_dir, f"instances_attributes_{subset}2020.json")
        image_dir = os.path.join(self.local_base_dir, name)
        cache = os.path.join(self.archive_base_dir,
                             f"{name}_full_annotations_df.json")
        self._df = coco_json_to_dataframe(json_path, image_dir, cache)
        return self._df

    def citation(self) -> str:
        return ("Jia et al., 'Fashionpedia: Ontology, Segmentation, and an "
                "Attribute Localization Dataset', ECCV 2020.")


class UnsplashLite(DatasetLoader):
    """Unsplash-lite TSV metadata: keyword labels, no boxes
    (classification-style rows)."""

    urls = {"unsplash-research-dataset-lite-latest.zip":
            "https://unsplash.com/data/lite/latest"}

    def dataframes(self, subset: str = "train"):
        import pandas as pd

        photos = pd.read_csv(
            os.path.join(self.local_base_dir, "photos.tsv000"), sep="\t")
        keywords = pd.read_csv(
            os.path.join(self.local_base_dir, "keywords.tsv000"), sep="\t")
        kw = keywords.groupby("photo_id")["keyword"].apply(
            lambda s: [[str(w)] for w in s][:16])
        df = photos[["photo_id", "photo_image_url", "photo_width",
                     "photo_height"]].rename(columns={
                         "photo_image_url": "image_path",
                         "photo_width": "width", "photo_height": "height"})
        df["category"] = df["photo_id"].map(kw)
        df = df.dropna(subset=["category"]).reset_index(drop=True)
        df["id_num"] = np.arange(len(df))
        df["num_boxes"] = df["category"].apply(len)
        df["attribute"] = df["category"].apply(
            lambda c: [[PAD_TOKEN]] * len(c))
        df["bbox"] = df["category"].apply(
            lambda c: [[0.0, 0.0, 1.0, 1.0]] * len(c))
        self._df = df
        return df


class SyntheticShapes(DatasetLoader):
    """Procedural detection dataset: colored axis-aligned rectangles on a
    noisy background. Categories = color names; attributes = size/aspect
    descriptors. Fully deterministic given ``seed``; no downloads.

    ``dataframes("val")`` is a disjoint split (seed offset 10000).
    Difficulty knobs: ``min_objects``/``max_objects`` (objects per image),
    ``size_range`` (normalized box side range; ``hard()``'s (0.04, 0.6) at
    640px spans the COCO small, medium and large area buckets) and
    ``num_val_images`` (the val split's size, ``num_images`` by default).
    Objects may overlap; later draws occlude earlier ones (z-order), and
    boxes keep their full extent.
    """

    COLORS = {"red": (0.9, 0.1, 0.1), "green": (0.1, 0.8, 0.15),
              "blue": (0.12, 0.2, 0.9), "yellow": (0.9, 0.85, 0.1),
              "magenta": (0.85, 0.1, 0.8), "cyan": (0.1, 0.85, 0.85)}
    SIZES = ["small", "large"]
    ASPECTS = ["wide", "tall", "square"]

    def __init__(self, num_images: int = 64, image_size: int = 64,
                 max_objects: int = 3, seed: int = 0,
                 min_objects: int = 1,
                 size_range: tuple = (0.15, 0.5),
                 num_val_images: Optional[int] = None):
        super().__init__(archive_base_dir="/tmp/synthetic",
                         local_base_dir="/tmp/synthetic")
        self.num_images = num_images
        self.image_size = image_size
        self.max_objects_cfg = max_objects
        self.min_objects_cfg = min_objects
        self.size_range = tuple(size_range)
        self.num_val_images = (num_images if num_val_images is None
                               else num_val_images)
        self.seed = seed
        self._images: Dict[int, np.ndarray] = {}

    @classmethod
    def hard(cls, num_images: int = 256, image_size: int = 640,
             num_val_images: int = 64, seed: int = 0) -> "SyntheticShapes":
        """The held-out quality suite: up to 8 overlapping objects, box
        sides 0.04-0.6 (25-384px at 640px, areas in all three COCO
        buckets)."""
        return cls(num_images=num_images, image_size=image_size,
                   max_objects=8, min_objects=2, size_range=(0.04, 0.6),
                   num_val_images=num_val_images, seed=seed)

    def get_data(self, download: bool = True, unzip: bool = True) -> None:
        pass  # nothing to fetch

    def get_vocab(self) -> Dict[str, List[str]]:
        return {"category": sorted(self.COLORS),
                "attribute": sorted(self.SIZES + self.ASPECTS)}

    def render(self, image_id: int) -> np.ndarray:
        return self._images[image_id]

    def rows(self, subset: str = "train") -> List[Dict]:
        """The rows of ``dataframes(subset)`` as a list of dicts, rendering
        the split's images (``render``); needs no pandas."""
        offset = 0 if subset == "train" else 10_000
        rng = np.random.default_rng(self.seed + offset)
        s = self.image_size
        rows = []
        color_names = sorted(self.COLORS)
        count = self.num_images if subset == "train" else self.num_val_images
        lo, hi = self.size_range
        for idx in range(count):
            img = rng.uniform(0.0, 0.15, (s, s, 3)).astype(np.float32)
            n = int(rng.integers(self.min_objects_cfg,
                                 self.max_objects_cfg + 1))
            boxes, cats, atts = [], [], []
            for _ in range(n):
                w = float(rng.uniform(lo, hi))
                h = float(rng.uniform(lo, hi))
                x = float(rng.uniform(0, 1 - w))
                y = float(rng.uniform(0, 1 - h))
                color = color_names[int(rng.integers(len(color_names)))]
                rgb = self.COLORS[color]
                x0, y0 = int(x * s), int(y * s)
                x1, y1 = max(x0 + 1, int((x + w) * s)), max(
                    y0 + 1, int((y + h) * s))
                img[y0:y1, x0:x1] = rgb
                boxes.append([x, y, w, h])
                cats.append([color])
                size = "large" if w * h > 0.06 else "small"
                aspect = ("square" if 0.75 < w / h < 1.33 else
                          "wide" if w > h else "tall")
                atts.append([size, aspect])
            self._images[idx + offset] = img
            rows.append({
                "id_num": idx + offset,
                "image_path": f"synthetic://{subset}/{idx}",
                "width": s, "height": s, "num_boxes": n,
                "bbox": boxes, "category": cats, "attribute": atts,
            })
        return rows

    def dataframes(self, subset: str = "train"):
        import pandas as pd

        self._df = pd.DataFrame(self.rows(subset))
        return self._df


class ClothingDatasetGrigorev(DatasetLoader):
    """Grigorev clothing dataset (a git repository with ``images.csv``,
    columns image, sender_id, label, kids): one whole-image box a row."""

    GIT_URL = "https://github.com/alexeygrigorev/clothing-dataset.git"

    def get_data(self, download: bool = True, unzip: bool = True) -> None:
        import subprocess

        os.makedirs(self.local_base_dir, exist_ok=True)
        repo = os.path.join(self.local_base_dir, "clothing-dataset")
        if download and not os.path.exists(repo):
            subprocess.run(["git", "clone", "--depth", "1", self.GIT_URL,
                            repo], check=True, capture_output=True)

    def dataframes(self, subset: str = "train"):
        import pandas as pd

        repo = os.path.join(self.local_base_dir, "clothing-dataset")
        df = pd.read_csv(os.path.join(repo, "images.csv"))
        df = df[df["label"] != "Not sure"].reset_index(drop=True)
        out = pd.DataFrame({
            "id_num": np.arange(len(df)),
            "image_path": df["image"].apply(
                lambda x: os.path.join(repo, "images", f"{x}.jpg")),
            "width": 0, "height": 0,  # unknown until decode
            "num_boxes": 1,
            "bbox": [[[0.0, 0.0, 1.0, 1.0]]] * len(df),
            "category": [[[label]] for label in df["label"]],
            "attribute": [[[PAD_TOKEN]]] * len(df),
        })
        self._df = out
        return out

    def citation(self) -> str:
        return ("Grigorev, 'Clothing dataset (full, high resolution)', "
                "https://github.com/alexeygrigorev/clothing-dataset")
