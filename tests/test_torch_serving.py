"""The port's serving artifact (boosted_detr_torch/serving.py, a
``torch.export`` program) against the JAX package's (boosted_detr_tpu/
serving.py, StableHLO through ``jax.export``) on the CPU, from the same
weights: ``DETR`` at tests/test_torch_boosted.py::TINY (ResNet
``patchify8`` at width 0.01, 64x64, 3 decoder blocks of width 16, float32;
the early-exit artifacts: tests/test_torch_serving_early_exit.py), weights
drawn on ``jax.eval_shape``'s tree (``tiny_variables``) and carried across
by ``load_flax_variables``.
The JAX side exports through its own ``export_serving`` from a namespace
that holds what that function reads of a Trainer (the model, its config,
the codec and the state's params and batch statistics), so that no JAX
init is compiled. The two sides sum in other orders only: raw outputs are
held to 1e-5 (tests/test_torch_trainer_jax.py's ``TOL``) and decoded
strings must be equal. Also: the exported graphs name the forward kernels'
registered ops (``boosted_detr::patchify_fwd`` and ``boosted_detr::
attention_fwd``), so no plain route is baked in, and a fresh process serves
an artifact without importing ``boosted_detr_torch.models``."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch import serving
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_tpu import serving as jserving
from boosted_detr_tpu.config import ModelConfig as JaxConfig
from boosted_detr_tpu.data.codec import TextCodec as JaxCodec
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from test_torch_boosted import TINY, tiny_variables

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
# TINY's 6 categories and 4 attributes, <PAD> and <OOV> included
VOCAB = {"category": ["c0", "c1", "c2", "c3"], "attribute": ["a0", "a1"]}
B = 6


def _images(seed, b=B):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (b, 64, 64, 3)).astype(np.float32)


def _jax_artifact(jmodel, variables, path, **kw):
    """JAX's ``export_serving`` on a namespace holding what it reads of a
    Trainer."""
    trainer = types.SimpleNamespace(
        model=jmodel, model_cfg=jmodel.config, codec=JaxCodec(VOCAB),
        state=types.SimpleNamespace(params=variables["params"],
                                    batch_stats=variables["batch_stats"]))
    jserving.export_serving(trainer, path, platforms=("cpu",), **kw)
    return jserving.load_serving(path)


def _port_trainer(model_cls, variables, **cfg_kw):
    cfg = bt.ModelConfig(**dict(dict(TINY, **cfg_kw), use_pallas_stem=True))
    model = model_cls(cfg, device="cpu")
    bt.load_flax_variables(model, variables)
    return bt.Trainer(model, cfg, bt.TrainConfig(), codec=TextCodec(VOCAB),
                      device="cpu").compile()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The standard DETR artifact of both packages from the same weights."""
    tmp = tmp_path_factory.mktemp("artifacts")
    image = _images(0)
    jdetr = JaxDETR(JaxConfig(**TINY))
    variables = tiny_variables(jdetr, image, seed=1)
    trainer = _port_trainer(bt.DETR, variables)
    return {"image": image, "tmp": tmp, "trainer": trainer,
            "jax": _jax_artifact(jdetr, variables, str(tmp / "jax")),
            "port": serving.load_serving(serving.export_serving(
                trainer, str(tmp / "port"), platforms="cpu"))}


def _close_raw(ours, ref, keys=("category", "attribute", "boxes")):
    for k in keys:
        np.testing.assert_allclose(ours[k], np.asarray(ref[k]), rtol=0,
                                   atol=TOL, err_msg=k)


def test_standard_artifact_matches_jax(artifacts):
    ours, ref = artifacts["port"], artifacts["jax"]
    for b in (B, 3, 1):  # the batch dimension is symbolic on both sides
        image = artifacts["image"][:b]
        raw = ours(image, decode_text=False)
        assert raw.keys() == {"category", "attribute", "boxes"}
        assert raw["boxes"].shape == (b, TINY["num_object_preds"], 4)
        _close_raw(raw, ref(image, decode_text=False))
    cats, atts, boxes, extras = ours(artifacts["image"])
    ref_cats, ref_atts, ref_boxes, ref_extras = ref(artifacts["image"])
    np.testing.assert_array_equal(cats, ref_cats)
    np.testing.assert_array_equal(atts, ref_atts)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=0, atol=TOL)
    assert extras == ref_extras == {}
    # and the live model's predict, bit for bit: the same ops on the CPU
    want = artifacts["trainer"].predict(artifacts["image"], decode_text=False)
    for k, v in ours(artifacts["image"], decode_text=False).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_standard_artifact_refuses_a_threshold(artifacts):
    image = artifacts["image"]
    for served in (artifacts["port"], artifacts["jax"]):
        with pytest.raises(ValueError, match="early_exit"):
            served(image, threshold=0.5)


def test_serving_config_has_jax_keys(artifacts):
    with open(artifacts["tmp"] / "port" / serving.CONFIG) as f:
        ours = json.load(f)
    with open(artifacts["tmp"] / "jax" / "serving_config.json") as f:
        ref = json.load(f)
    assert ours.pop("platforms") == ["cpu"]
    assert ours == ref


def _kernel_ops(served):
    ops = [str(n.target) for n in served.program.graph.nodes
           if str(n.target).startswith("boosted_detr.")]
    return {op: ops.count(op) for op in set(ops)}


def test_exported_graphs_name_the_kernel_ops(artifacts, tmp_path):
    """The ResNet stem's K1 and every attention of a ViT DETR with
    ``use_pallas_attention`` stay registered ops in the exported graph:
    nothing of their plain versions is traced in, so the same program on
    the card launches the kernels."""
    assert _kernel_ops(artifacts["port"]) == {
        "boosted_detr.patchify_fwd.default": 1}
    cfg = bt.ModelConfig(**dict(TINY, backbone="vit_p16_d1_w32_h2",
                                backbone_width=1.0, num_encoder_blocks=1,
                                num_decoder_blocks=2, use_pallas_stem=True,
                                use_pallas_attention=True))
    model = bt.DETR(cfg, device="cpu", seed=3)
    trainer = bt.Trainer(model, cfg, bt.TrainConfig(), codec=TextCodec(VOCAB),
                         device="cpu").compile()
    served = serving.load_serving(serving.export_serving(
        trainer, str(tmp_path / "vit"), platforms="cpu"))
    # a ViT block, an encoder block, 2 cross-attentions and the decoder
    # self-attention of block 1 (block 0 has none)
    assert _kernel_ops(served) == {"boosted_detr.patchify_fwd.default": 1,
                                   "boosted_detr.attention_fwd.default": 5}
    image = artifacts["image"][:2]
    want = trainer.predict(image, decode_text=False)
    for k, v in served(image, decode_text=False).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


_SERVE = """
import sys
import numpy as np
from boosted_detr_torch import serving
served = serving.load_serving(sys.argv[1])
raw = served(np.load(sys.argv[2]), decode_text=False)
loaded = sorted(m for m in sys.modules
                if m.startswith(("boosted_detr_torch.models", "jax",
                                 "boosted_detr_tpu")))
np.savez(sys.argv[3], **raw)
print("loaded:", loaded)
"""


def test_a_fresh_process_serves_without_the_models(artifacts, tmp_path):
    path = str(artifacts["tmp"] / "port")
    np.save(tmp_path / "images.npy", artifacts["image"])
    out = subprocess.run(
        [sys.executable, "-c", _SERVE, path, str(tmp_path / "images.npy"),
         str(tmp_path / "raw.npz")], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "loaded: []", out.stdout
    got = np.load(tmp_path / "raw.npz")
    want = artifacts["port"](artifacts["image"], decode_text=False)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
