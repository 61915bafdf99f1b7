"""The weight bridge (boosted_detr_torch/bridge.py), the port's own copies of
the JAX package's numpy-only modules, and the rule that the port never
imports JAX or the JAX package."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.data import codec as tcodec
from boosted_detr_torch.data import vocabularies as tvocab
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.data import codec as jcodec
from boosted_detr_tpu.data import vocabularies as jvocab
from boosted_detr_tpu.models.detr import DETR as JaxDETR

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(image_size=(64, 64), backbone="resnet", backbone_width=0.01,
             stem="patchify8", use_pallas_stem=True, num_encoder_blocks=1,
             num_decoder_blocks=2, num_encoder_heads=4, num_decoder_heads=4,
             encoder_dim=32, decoder_dim=32, num_object_preds=8,
             num_categories=7, num_attributes=8, compute_dtype="float32")


@pytest.fixture(scope="module")
def flax_variables():
    image = np.zeros((1, 64, 64, 3), np.float32)
    variables = JaxDETR(jconfig.ModelConfig(**SMALL)).init(
        jax.random.PRNGKey(0), image)
    rng = np.random.default_rng(0)
    # distinct values everywhere, so that a transposed or swapped leaf shows
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        variables)


def _model():
    return bt.DETR(bt.ModelConfig(**SMALL), device="cpu")


def test_every_leaf_fills_every_entry(flax_variables):
    model = _model()
    bt.load_flax_variables(model, flax_variables)  # raises on any leftover
    n_leaves = len(jax.tree_util.tree_leaves(flax_variables))
    assert n_leaves == len(model.state_dict())
    params, stats = flax_variables["params"], flax_variables["batch_stats"]
    state = model.state_dict()
    # Dense [in, out] -> [out, in]
    np.testing.assert_array_equal(
        state["decoder_block_1.self_attention.attention.query_projection"
              ".weight"].numpy(),
        params["decoder_block_1"]["self_attention"]["attention"][
            "query_projection"]["kernel"].T)
    # Conv HWIO -> OIHW
    np.testing.assert_array_equal(
        state["backbone.resnet.stem.conv.weight"].numpy(),
        params["backbone"]["resnet"]["stem"]["conv"]["kernel"].transpose(
            3, 2, 0, 1))
    # BatchNorm scale/bias and mean/var
    np.testing.assert_array_equal(state["neck.norm1.weight"].numpy(),
                                  params["neck"]["norm1"]["scale"])
    np.testing.assert_array_equal(state["neck.norm1.running_var"].numpy(),
                                  stats["neck"]["norm1"]["var"])
    np.testing.assert_array_equal(
        state["encoder.positional_encoding"].numpy(),
        params["encoder"]["positional_encoding"])
    np.testing.assert_array_equal(state["decoder_prep.object_queries"].numpy(),
                                  params["decoder_prep"]["object_queries"])


def test_unmapped_keys_raise_on_either_side(flax_variables):
    extra = {"params": dict(flax_variables["params"],
                            stray={"kernel": np.zeros((2, 2), np.float32)}),
             "batch_stats": flax_variables["batch_stats"]}
    with pytest.raises(KeyError, match="stray"):
        bt.load_flax_variables(_model(), extra)
    params = dict(flax_variables["params"])
    del params["box_head"]
    with pytest.raises(KeyError, match="box_head"):
        bt.load_flax_variables(
            _model(), {"params": params,
                       "batch_stats": flax_variables["batch_stats"]})
    params = dict(flax_variables["params"])
    params["neck"] = dict(params["neck"], conv={
        "kernel": np.zeros((1, 1, 32, 16), np.float32),
        "bias": np.zeros(16, np.float32)})
    with pytest.raises(ValueError, match="neck/conv"):
        bt.load_flax_variables(
            _model(), {"params": params,
                       "batch_stats": flax_variables["batch_stats"]})


def test_model_config_copy_has_the_same_fields_and_defaults():
    ours = [(f.name, f.default) for f in dataclasses.fields(bt.ModelConfig)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(jconfig.ModelConfig)]
    assert ours == ref
    assert (bt.config.PAD_TOKEN, bt.config.OOV_TOKEN) == (
        jconfig.PAD_TOKEN, jconfig.OOV_TOKEN)
    cfg = bt.ModelConfig(image_size=(640, 640), decoder_dim=128)
    ref_cfg = jconfig.ModelConfig(image_size=(640, 640), decoder_dim=128)
    assert cfg.grid_size == ref_cfg.grid_size == (20, 20)
    assert cfg.resolved_head_hidden_dim == ref_cfg.resolved_head_hidden_dim


@pytest.mark.parametrize("name", ["COCO", "Fashionpedia"])
def test_vocabulary_and_codec_copies(name):
    assert tvocab.vocab_dict(name) == jvocab.vocab_dict(name)
    ours = tcodec.TextCodec(tvocab.vocab_dict(name))
    ref = jcodec.TextCodec(jvocab.vocab_dict(name))
    assert ours.category_vocab == ref.category_vocab
    assert ours.attribute_vocab == ref.attribute_vocab
    cats = [[ref.category_vocab[2], "no-such-word"], []]
    np.testing.assert_array_equal(ours.encode_categories(cats, 3),
                                  ref.encode_categories(cats, 3))
    atts = [[[ref.attribute_vocab[-1], "<PAD>"]], []]
    np.testing.assert_array_equal(ours.encode_attributes(atts, 2, 3),
                                  ref.encode_attributes(atts, 2, 3))


# The JAX stack, the JAX package, and the JAX repo's benchmark suite
# (benchmarks/, bench.py): the port keeps its own copies.
_BANNED = ("jax", "jaxlib", "flax", "optax", "boosted_detr_tpu", "benchmarks",
           "bench")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


# The training loop's modules: each imports with torch, numpy and scipy
# alone (the optional host packages are imported where they are used).
_HOST_MODULES = {
    "config.py": "boosted_detr_torch.config",
    "data/datasets.py": "boosted_detr_torch.data.datasets",
    "data/pipeline.py": "boosted_detr_torch.data.pipeline",
    "data/tfrecord.py": "boosted_detr_torch.data.tfrecord",
    "data/grain_loader.py": "boosted_detr_torch.data.grain_loader",
    "data/augment.py": "boosted_detr_torch.data.augment",
    "data/device_synth.py": "boosted_detr_torch.data.device_synth",
    "native/__init__.py": "boosted_detr_torch.native",
    "native/lap_binding.py": "boosted_detr_torch.native.lap_binding",
    "native/imgload_binding.py": "boosted_detr_torch.native.imgload_binding",
    "train/profiling.py": "boosted_detr_torch.train.profiling",
    "train/trainer.py": "boosted_detr_torch.train.trainer",
    "utils/visualize.py": "boosted_detr_torch.utils.visualize",
    "api.py": "boosted_detr_torch.api",
    "cli.py": "boosted_detr_torch.cli",
    "serving.py": "boosted_detr_torch.serving",
}
_OPTIONAL = ("pandas", "tensorflow", "grain", "PIL", "cv2", "matplotlib",
             "yaml", "requests", "tensorboard")


def test_new_modules_import_without_the_optional_host_packages():
    """In a fresh interpreter whose ``sys.modules`` entries for the
    optional packages are None (an import of any of them raises), every
    module of the training loop and the package's names import."""
    code = "\n".join([
        "import sys",
        f"for name in {_OPTIONAL!r}:",
        "    sys.modules[name] = None",
        "import importlib",
        f"for m in {sorted(_HOST_MODULES.values())!r}:",
        "    importlib.import_module(m)",
        "import boosted_detr_torch as bt",
        "assert bt.Trainer and bt.Pipeline and bt.SyntheticShapes",
        "print('imported')"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "boosted_detr_torch").rglob("*.py"))
    roots = [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert len(files) > 10 and all(f.exists() for f in roots)
    scanned = {str(f.relative_to(ROOT / "boosted_detr_torch"))
               for f in files}
    files += roots
    assert {"ops/boxes.py", "ops/losses.py", "ops/lap.py", "ops/matching.py",
            "train/schedules.py", "train/steps.py", "models/boosted.py",
            "models/early_exit.py", "models/panoptic.py",
            "models/pretrainer.py", "models/pretrained.py", "data/masks.py",
            "train/metrics.py", "api.py", "cli.py",
            "serving.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharding.py", "parallel/multiprocess.py",
            "parallel/context_parallel.py",
            "parallel/dryrun.py", "benchmarks/__init__.py",
            "benchmarks/run_benchmarks.py", "benchmarks/profile_step.py",
            "benchmarks/roofline.py"} | set(_HOST_MODULES) <= scanned
    found = [(str(f.relative_to(ROOT)), name) for f in files
             for name in _imports(f)
             if name.split(".")[0] in _BANNED]
    assert not found
