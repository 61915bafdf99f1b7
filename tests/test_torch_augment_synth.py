"""The port's augmentations and its renderer on the device
(boosted_detr_torch/data/augment.py, data/device_synth.py) against the JAX
package's. The two packages' random streams cannot match, so each random
transform is held with the draws passed in: JAX's draws are made from its
key as its functions make them, then handed to the port's pure function,
and the outputs are held within 1e-6 (float32 arithmetic in another
order: measured at 1.8e-7 on the images, 0 on boxes and masks).
``rasterize``, ``scene_labels`` and ``scene_masks`` of one JAX scene are
held bit for bit. JAX runs under ``jax.jit``, as the package runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosted_detr_torch.data import augment as taug
from boosted_detr_torch.data import datasets as tds
from boosted_detr_torch.data import device_synth as tsynth
from boosted_detr_torch.data import codec as tcodec
from boosted_detr_torch.data import masks as tmasks
from boosted_detr_tpu.data import augment as jaug
from boosted_detr_tpu.data import device_synth as jsynth

torch.set_num_threads(2)
TOL = 1e-6
B, H, W, O, S = 4, 48, 40, 5, 24


def _jax_draws(key):
    """The numbers ``augment_one(key, ...)`` draws, in the port's form."""
    ks = jax.random.split(key, 4)
    k1, k2, k3 = jax.random.split(ks[0], 3)
    return {"shrink": jaug._truncated_shrink(k1, (2,)),
            "shift": jnp.stack([jax.random.uniform(k2, ()),
                                jax.random.uniform(k3, ())]),
            "contrast": jax.random.uniform(ks[1], (), minval=0.8, maxval=1.2),
            "brightness": jax.random.uniform(ks[2], (), minval=-0.1,
                                             maxval=0.1),
            "saturation": jax.random.uniform(ks[3], (), minval=0.8,
                                             maxval=1.2)}


@pytest.fixture(scope="module")
def reference():
    """One batch with pad boxes and masks through JAX's ``augment_batch``,
    and the draws it made."""
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             "bbox": rng.uniform(0.05, 0.45, (B, O, 4)).astype(np.float32),
             "masks": (rng.uniform(0, 1, (B, O, S, S)) > 0.6).astype(
                 np.float32)}
    batch["bbox"][:, -2:] = -10.0  # pad boxes
    key = jax.random.PRNGKey(11)
    out = jax.jit(jaug.augment_batch)(key, batch)
    keys = jax.random.split(key, B)
    draws = jax.jit(jax.vmap(_jax_draws))(keys)
    no_masks = jax.jit(jaug.augment_batch)(
        key, {k: batch[k] for k in ("image", "bbox")})
    as_np = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa
    return {"batch": batch, "out": as_np(out), "draws": as_np(draws),
            "no_masks": as_np(no_masks), "keys": np.asarray(keys)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_close(ours, ref, what):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    err = np.abs(ours - np.asarray(ref)).max()
    assert err <= TOL, f"{what}: {err:.3e}"


def test_apply_augmentations_matches_jax_with_its_draws(reference):
    out = taug.apply_augmentations(_torch(reference["batch"]),
                                   _torch(reference["draws"]))
    for k in ("image", "bbox", "masks"):
        _assert_close(out[k], reference["out"][k], k)
    out = taug.apply_augmentations(
        _torch({k: reference["batch"][k] for k in ("image", "bbox")}),
        _torch(reference["draws"]))
    assert "masks" not in out
    for k in ("image", "bbox"):
        _assert_close(out[k], reference["no_masks"][k], k)


def test_each_transform_matches_jax_with_its_draws(reference):
    batch, draws = reference["batch"], _torch(reference["draws"])
    for i, key in enumerate(reference["keys"]):
        ks = jax.random.split(key, 4)
        image, bbox = batch["image"][i], batch["bbox"][i]
        masks = batch["masks"][i]
        ref = jax.jit(jaug.random_downsize_shift_pad)(ks[0], image, bbox,
                                                      masks)
        ours = taug.downsize_shift_pad(
            torch.from_numpy(image[None]), torch.from_numpy(bbox[None]),
            draws["shrink"][i:i + 1], draws["shift"][i:i + 1],
            torch.from_numpy(masks[None]))
        for o, r, what in zip(ours, ref, ("image", "bbox", "masks")):
            _assert_close(o[0], r, f"downsize_shift_pad {what}")
        x = torch.from_numpy(image[None])
        for name, fn in (("contrast", taug.contrast),
                         ("brightness", taug.brightness),
                         ("saturation", taug.saturation)):
            k = {"contrast": ks[1], "brightness": ks[2],
                 "saturation": ks[3]}[name]
            ref = jax.jit(getattr(jaug, f"random_{name}"))(k, image)
            _assert_close(fn(x, draws[name][i:i + 1])[0], ref, name)


def test_draws_keep_their_ranges():
    gen = torch.Generator().manual_seed(0)
    d = taug.draw_augmentations(gen, 4096)
    assert d["shrink"].min() >= 1.0 and d["shrink"].max() <= 0.5 + 1.4
    assert (d["shrink"] == 1.0).float().mean() > 0.3  # max(1, .) often 1
    assert 0 <= d["shift"].min() and d["shift"].max() < 1
    assert 0.8 <= d["contrast"].min() and d["contrast"].max() < 1.2
    assert -0.1 <= d["brightness"].min() and d["brightness"].max() < 0.1
    assert 0.8 <= d["saturation"].min() and d["saturation"].max() < 1.2


def test_augment_batch_keeps_boxes_in_the_image():
    """After the shrink, shift and pad the boxes still cover their objects:
    at each box centre the object's bright channels stay above 0.5 and its
    dark ones below (cyan's two equal channels leave no single dominant
    one)."""
    ds = tds.SyntheticShapes(num_images=4, image_size=64, max_objects=1,
                             seed=5)
    from boosted_detr_torch.data.pipeline import Pipeline

    codec = tcodec.TextCodec(ds.get_vocab())
    batch = next(Pipeline((64, 64), 1, codec, dataset=ds).batches(
        ds.dataframes("train"), 4, shuffle=False))
    out = taug.augment_batch(torch.Generator().manual_seed(7),
                             _torch({k: batch[k] for k in ("image", "bbox")}))
    img, box = out["image"].numpy(), out["bbox"].numpy()
    assert 0 <= img.min() and img.max() <= 1
    for i in range(4):
        x, y, w, h = box[i, 0]
        assert 0 <= x <= 1 and 0 <= y <= 1 and x + w <= 1 and y + h <= 1
        cx = int(np.clip((x + w / 2) * 64, 0, 63))
        cy = int(np.clip((y + h / 2) * 64, 0, 63))
        rgb = np.asarray(ds.COLORS[codec.category_vocab[
            batch["category_ids"][i, 0]]])
        np.testing.assert_array_equal(img[i, cy, cx] > 0.5, rgb > 0.5)


def test_one_image_functions_and_determinism():
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.uniform(0, 1, (16, 16, 3)).astype(
        np.float32))
    bbox = torch.from_numpy(rng.uniform(0.1, 0.4, (3, 4)).astype(np.float32))
    masks = torch.ones(3, 8, 8)
    a = taug.augment_one(torch.Generator().manual_seed(3), image, bbox, masks)
    b = taug.augment_one(torch.Generator().manual_seed(3), image, bbox, masks)
    assert [x.shape for x in a] == [(16, 16, 3), (3, 4), (3, 8, 8)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    gen = torch.Generator().manual_seed(4)
    assert taug.random_contrast(gen, image).shape == image.shape
    assert taug.random_brightness(gen, image).shape == image.shape
    assert taug.random_saturation(gen, image).shape == image.shape
    moved = taug.random_downsize_shift_pad(gen, image, bbox)
    assert [x.shape for x in moved] == [(16, 16, 3), (3, 4)]


def test_host_jpeg_quality_matches_jax():
    image = np.random.default_rng(2).uniform(0, 1, (2, 24, 24, 3)).astype(
        np.float32)
    ours = taug.host_augment({"image": image}, np.random.default_rng(9))
    ref = jaug.host_augment({"image": image}, np.random.default_rng(9))
    np.testing.assert_array_equal(ours["image"], ref["image"])


def _jax_scene(seed, slots=8):
    key = jax.random.PRNGKey(seed)
    k_scene, k_bg = jax.random.split(key)
    scene = jsynth.sample_scene(k_scene, 5, 1, (0.1, 0.6), slots)
    bg = jax.random.uniform(k_bg, (64, 64, 3), minval=0.0, maxval=0.15)
    return ({k: np.asarray(v) for k, v in scene.items()}, np.asarray(bg),
            np.asarray(jsynth.rasterize(k_bg, scene, 64)))


@pytest.mark.parametrize("seed", range(4))
def test_scene_functions_match_jax_bit_for_bit(seed):
    scene, bg, image = _jax_scene(seed)
    ours = _torch(scene)
    np.testing.assert_array_equal(
        tsynth.rasterize(torch.from_numpy(bg), ours, 64).numpy(), image)
    for o, r in zip(tsynth.scene_labels(ours),
                    jsynth.scene_labels(scene)):
        assert o.dtype == torch.int32 or o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tsynth.scene_masks(ours, 24).numpy(),
                                  np.asarray(jsynth.scene_masks(scene, 24)))


def test_batched_rasterize_is_per_image_rasterize():
    scenes, bgs, images = zip(*(_jax_scene(s) for s in range(3)))
    stacked = {k: torch.from_numpy(np.stack([sc[k] for sc in scenes]))
               for k in scenes[0]}
    out = tsynth.rasterize(torch.from_numpy(np.stack(bgs)), stacked, 64)
    np.testing.assert_array_equal(out.numpy(), np.stack(images))


def test_scene_masks_are_box_to_mask():
    scene, _, _ = _jax_scene(5)
    masks = tsynth.scene_masks(_torch(scene), 32).numpy()
    for j in range(8):
        if j < scene["n"]:
            np.testing.assert_array_equal(masks[j], tmasks.box_to_mask(
                [scene["x"][j], scene["y"][j], scene["w"][j],
                 scene["h"][j]], 32))
        else:
            assert not masks[j].any()


def test_batch_fn_shapes_and_pool_semantics():
    fn = tsynth.make_batch_fn(32, 4, 6, seed=0, device="cpu")
    b0 = fn(0)
    assert {k: tuple(v.shape) for k, v in b0.items()} == {
        "image": (4, 32, 32, 3), "category_ids": (4, 6),
        "attribute_ids": (4, 6, 8), "bbox": (4, 6, 4), "num_objects": (4,)}
    assert b0["image"].dtype == torch.float32
    assert b0["category_ids"].dtype == b0["num_objects"].dtype == torch.int32
    # streaming never repeats; step 1 is images 4-7
    b1 = fn(1)
    assert not torch.equal(b0["image"], b1["image"])
    # image i is a function of (seed, i) alone
    gen = torch.Generator().manual_seed(tsynth._seed(0, 1, 5))
    one = tsynth.render_image(gen, 32, 5, 1, (0.1, 0.6), 6)
    for k, v in one.items():
        assert torch.equal(v, b1[k][1]), k
    # pool of one: every image is the pool's
    fn1 = tsynth.make_batch_fn(32, 4, 6, pool_size=1, device="cpu")
    p0, p1 = fn1(0)["image"], fn1(9)["image"]
    assert torch.equal(p0[0], p0[1]) and torch.equal(p0[0], p1[3])
    # a pool of 3 holds 3 distinct images
    big = tsynth.make_batch_fn(32, 16, 6, pool_size=3,
                               device="cpu")(5)["image"].reshape(16, -1)
    assert 1 < len({tuple(r.tolist()) for r in big}) <= 3
    masks = tsynth.make_batch_fn(32, 2, 4, pool_size=16, mask_size=24,
                                 device="cpu")(0)["masks"]
    assert masks.shape == (2, 4, 24, 24) and masks.dtype == torch.float32


def test_object_stats_match_the_host_distribution():
    b = tsynth.make_batch_fn(32, 64, 8, max_objects=5, min_objects=1,
                             size_range=(0.1, 0.6), seed=3, device="cpu")(0)
    n = b["num_objects"].numpy()
    assert n.min() >= 1 and n.max() <= 5 and len(set(n.tolist())) == 5
    bbox = b["bbox"].numpy()
    active = bbox[..., 0] > -5
    assert (active.sum(-1) == n).all()
    sides = bbox[..., 2:][active]
    assert sides.min() >= 0.1 - 1e-6 and sides.max() <= 0.6 + 1e-6
    xy = bbox[..., :2][active]
    assert (xy >= -1e-6).all() and (xy + sides <= 1 + 1e-5).all()
    # the host renderer's attribute and category id ranges
    codec = tcodec.TextCodec(tds.SyntheticShapes().get_vocab())
    cats = b["category_ids"].numpy()[active]
    assert cats.min() >= 2 and cats.max() < len(codec.category_vocab)
