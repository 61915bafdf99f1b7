"""The port's box and loss primitives (boosted_detr_torch/ops/{boxes,losses}.py)
against the JAX package's (boosted_detr_tpu/ops/{boxes,losses}.py), float32,
on the same inputs made with numpy from fixed seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosted_detr_torch.ops import boxes as tb
from boosted_detr_torch.ops import losses as tl
from boosted_detr_tpu.ops import boxes as jb
from boosted_detr_tpu.ops import losses as jl

torch.set_num_threads(2)

# float32 on both sides: the formulas are the same, so only the rounding of
# log/pow and the order of float32 sums (einsum, means over <= 20 terms)
# differ; 1e-5 relative covers it with room.
F32 = dict(atol=1e-5, rtol=1e-5)


def _boxes(rng, shape):
    """COCO boxes [.., 4] in [0, 1], some degenerate (zero width)."""
    xy = rng.uniform(0.0, 0.7, shape[:-1] + (2,))
    wh = rng.uniform(0.0, 0.3, shape[:-1] + (2,))
    wh[..., 0][rng.uniform(size=shape[:-1]) < 0.1] = 0.0
    return np.concatenate([xy, wh], -1).astype(np.float32)


def _probs(rng, shape):
    p = rng.uniform(0.0, 1.0, shape)
    p[rng.uniform(size=shape) < 0.05] = 0.0  # exercise the clips
    p[rng.uniform(size=shape) < 0.05] = 1.0
    return p.astype(np.float32)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or F32))


@pytest.mark.parametrize("name", ["coco_to_corners", "corners_to_coco",
                                  "coco_to_voc", "voc_to_coco"])
def test_box_format_conversions(name):
    box = _boxes(np.random.default_rng(0), (3, 5, 4))
    _close(getattr(tb, name)(torch.from_numpy(box)),
           getattr(jb, name)(jnp.asarray(box)))


@pytest.mark.parametrize("name", ["iou_corners", "giou_corners", "giou_loss",
                                  "iou_loss"])
def test_iou_family_broadcasts_and_handles_degenerate_boxes(name):
    rng = np.random.default_rng(1)
    a = jb.coco_to_corners(jnp.asarray(_boxes(rng, (2, 6, 1, 4))))
    b = jb.coco_to_corners(jnp.asarray(_boxes(rng, (2, 1, 7, 4))))
    a = np.asarray(a).copy()
    a[0, 0, 0] = [0.3, 0.3, 0.3, 0.3]  # a point: zero union with itself
    b = np.asarray(b).copy()
    b[0, 0, 0] = [0.3, 0.3, 0.3, 0.3]
    ours = getattr(tb, name)(torch.from_numpy(a), torch.from_numpy(b))
    ref = getattr(jb, name)(jnp.asarray(a), jnp.asarray(b))
    assert ours.shape == (2, 6, 7)
    _close(ours, ref)
    assert torch.isfinite(ours).all()


def test_divide_no_nan_gives_zero_and_a_finite_gradient():
    num = torch.tensor([1.0, 2.0, 0.0], requires_grad=True)
    den = torch.tensor([2.0, 0.0, 0.0], requires_grad=True)
    out = tb.divide_no_nan(num, den)
    np.testing.assert_array_equal(out.detach().numpy(), [0.5, 0.0, 0.0])
    out.sum().backward()
    assert torch.isfinite(num.grad).all() and torch.isfinite(den.grad).all()


@pytest.mark.parametrize("name", ["binary_crossentropy", "exist_loss",
                                  "category_loss", "attribute_loss"])
def test_elementwise_losses(name):
    rng = np.random.default_rng(2)
    p = _probs(rng, (3, 5, 12))
    if name == "category_loss":
        y = np.eye(12, dtype=np.float32)[rng.integers(0, 12, (3, 5))]
    else:
        y = (rng.uniform(size=(3, 5, 12)) < 0.3).astype(np.float32)
    _close(getattr(tl, name)(torch.from_numpy(y), torch.from_numpy(p)),
           getattr(jl, name)(jnp.asarray(y), jnp.asarray(p)))


def test_safe_clip_and_focal():
    rng = np.random.default_rng(3)
    p = _probs(rng, (4, 9))
    y = (rng.uniform(size=(4, 9)) < 0.5).astype(np.float32)
    _close(tl.safe_clip(torch.from_numpy(p)), jl.safe_clip(jnp.asarray(p)))
    _close(tl.sigmoid_focal_elementwise(torch.from_numpy(y),
                                        torch.from_numpy(p)),
           jl.sigmoid_focal_elementwise(jnp.asarray(y), jnp.asarray(p)))


@pytest.mark.parametrize("weights", [(2.0, 5.0), (1.0, 0.5)])
def test_box_loss(weights):
    rng = np.random.default_rng(4)
    y, p = _boxes(rng, (3, 8, 4)), _boxes(rng, (3, 8, 4))
    _close(tl.box_loss(torch.from_numpy(y), torch.from_numpy(p), *weights),
           jl.box_loss(jnp.asarray(y), jnp.asarray(p), *weights))


def test_pairwise_costs():
    rng = np.random.default_rng(5)
    b, o, p_count, vc, va = 2, 6, 10, 12, 20
    y_cat = np.eye(vc, dtype=np.float32)[rng.integers(0, vc, (b, o))]
    y_att = (rng.uniform(size=(b, o, va)) < 0.2).astype(np.float32)
    p_cat = _probs(rng, (b, p_count, vc))
    p_att = _probs(rng, (b, p_count, va))
    y_box, p_box = _boxes(rng, (b, o, 4)), _boxes(rng, (b, p_count, 4))
    t = torch.from_numpy
    j = jnp.asarray
    ours = tl.category_cost(t(y_cat), t(p_cat))
    assert ours.shape == (b, o, p_count)
    _close(ours, jl.category_cost(j(y_cat), j(p_cat)))
    _close(tl.attribute_cost(t(y_att), t(p_att)),
           jl.attribute_cost(j(y_att), j(p_att)))
    _close(tl.pairwise(tl.box_loss, t(y_box), t(p_box)),
           jl.box_cost(j(y_box), j(p_box)))
    _close(tl.iou_metric_pairwise(t(y_box), t(p_box)),
           jl.iou_metric_pairwise(j(y_box), j(p_box)))
    # the einsum forms equal the broadcast definitions they replace
    _close(tl.category_cost(t(y_cat), t(p_cat)),
           tl.pairwise(tl.category_loss, t(y_cat), t(p_cat)).numpy())
    _close(tl.attribute_cost(t(y_att), t(p_att)),
           tl.pairwise(tl.attribute_loss, t(y_att), t(p_att)).numpy())
