"""The port's command line (boosted_detr_torch/cli.py) against the JAX
package's (boosted_detr_tpu/cli.py) on the CPU: ``_parse_sets`` and
``_build_model`` give the same overrides, ``ModelConfig``,
``TrainConfig`` and API class as JAX's for the same arguments (dotted
``--set`` keys, ``--synthetic``'s overrides, ``--checkpoint-dir``, a YAML
``--config``); then the port's ``train`` (with ``--scan-steps``,
``--eval-map``, the CSV log and ``--save``), ``evaluate``, ``export`` (for
the CPU, the early-exit program) and the pre-train -> transfer flow, run in
this process with ``--device cpu`` at the synthetic dataset's 64x64 and
tiny widths, and what it refuses. No learning is measured here: that is
tests/test_torch_learning.py's (slow)."""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from boosted_detr_torch import cli, serving
from boosted_detr_tpu import cli as jcli

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
VOCAB = {"category": ["c0", "c1", "c2", "c3"], "attribute": ["a0", "a1"]}
TINY_SETS = ["model.num_object_preds=8", "model.num_encoder_blocks=1",
             "model.num_encoder_heads=2", "model.encoder_dim=16",
             "model.num_decoder_blocks=2", "model.num_decoder_heads=2",
             "model.decoder_dim=16", "model.backbone_width=0.25",
             "train.batch_size=4"]
DATA = ["--synthetic", "--synthetic-images", "8", "--device", "cpu"]


def test_parse_sets_matches_jax():
    pairs = ["model.encoder_dim=128", "train.learning_rate=0.01",
             "model.backbone=resnet", "model.matcher='pallas'",
             "model.image_size=(64, 64)", "model.use_pallas_stem=True",
             "train.loss_weights={'category': 2.0}", "model.stem=a=b",
             "train.seed=-3"]
    ours = cli._parse_sets(pairs)
    assert ours == jcli._parse_sets(pairs)
    assert ours["model.image_size"] == (64, 64)
    assert ours["model.matcher"] == "pallas"
    assert cli._parse_sets(None) == jcli._parse_sets(None) == {}


def _args(model="detr", sets=(), synthetic=False, config=None,
          checkpoint_dir=None):
    return argparse.Namespace(model=model, set=list(sets), config=config,
                              synthetic=synthetic, device="cpu",
                              checkpoint_dir=checkpoint_dir)


def _yaml(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "model:\n  backbone: tiny\n  image_size: [32, 32]\n"
        "  num_object_preds: 8\n  encoder_dim: 16\n  decoder_dim: 16\n"
        "  num_encoder_heads: 2\n  num_decoder_heads: 2\n"
        "  compute_dtype: float32\n"
        "train:\n  batch_size: 2\n  loss_weights: {attribute: 7.0}\n")
    return str(path)


CASES = {
    "synthetic-tiny": dict(model="synthetic-tiny", synthetic=True,
                           sets=["train.batch_size=4"]),
    "boosted": dict(model="boosted", synthetic=True,
                    sets=TINY_SETS + ["model.matcher='pallas'"],
                    checkpoint_dir="ckpt"),
    "panoptic": dict(model="panoptic", synthetic=True,
                     sets=TINY_SETS + ["model.num_panoptic_heads=2",
                                       "model.panoptic_dim=16"]),
    "detr": dict(model="detr", sets=TINY_SETS + [
        "model.backbone='resnet'", "model.stem=patchify8",
        "model.image_size=(64, 64)", "model.compute_dtype='float32'",
        "model.use_pallas_attention=True", "train.ema_decay=0.9",
        "train.optimizer=adamw"]),
    "yaml": dict(model="pretrainer", config="yaml",
                 sets=["model.decoder_dim=32", "train.seed=4"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_model_matches_jax(case, tmp_path):
    kw = dict(CASES[case])
    if kw.get("config") == "yaml":
        kw["config"] = _yaml(tmp_path)
    if kw.get("checkpoint_dir"):
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    ours, tcfg = cli._build_model(_args(**kw), VOCAB)
    ref, ref_tcfg = jcli._build_model(_args(**kw), VOCAB)
    assert type(ours).__name__ == type(ref).__name__
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(ref.config)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(ref_tcfg)
    assert (dataclasses.asdict(ours.loss_weights)
            == dataclasses.asdict(ref.loss_weights))
    assert ours.device.type == "cpu"


def test_train_evaluate_export_on_the_cpu(tmp_path, capsys):
    save, log = str(tmp_path / "model"), str(tmp_path / "log.csv")
    rc = cli.main(["train", *DATA, "--model", "synthetic-tiny",
                   "--set", "train.batch_size=4", "--scan-steps", "2",
                   "--eval-map", "--log-csv", log, "--save", save])
    out = capsys.readouterr().out
    assert rc == 0 and "final loss:" in out and "val mAP:" in out, out
    assert os.path.exists(log)
    assert sorted(os.listdir(save)) == ["model_config.json", "weights"]

    rc = cli.main(["evaluate", *DATA, "--load", save, "--batch-size", "4"])
    out = capsys.readouterr().out
    assert rc == 0 and "mAP:" in out, out

    artifact = str(tmp_path / "artifact")
    rc = cli.main(["export", "--load", save, "--out", artifact,
                   "--platforms", "cpu", "--early-exit",
                   "--exit-criterion", "stability"])
    assert rc == 0 and "early-exit (stability" in capsys.readouterr().out
    served = serving.load_serving(artifact)
    assert served.meta["platforms"] == ["cpu"]
    assert served.meta["exit_criterion"] == "stability"
    image = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    cats, _, boxes, extras = served(image, threshold=0.5)
    assert cats.shape == (2, 12) and np.isfinite(boxes).all()
    assert extras["exit_block"].shape == (2,)
    # the default platform is the card: without one, export raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["export", "--load", save, "--out", artifact])


def test_pretrain_then_transfer_flow(capsys):
    sets = [a for s in TINY_SETS for a in ("--set", s)]
    rc = cli.main(["train", *DATA, "--model", "pretrainer",
                   "--pretrain-epochs", "1", "--epochs", "1", *sets])
    out = capsys.readouterr().out
    assert rc == 0 and "pretrain loss=" in out, out
    assert "trunk transferred to the detector" in out


def test_what_the_cli_refuses():
    # a multi-process launch needs its rank (two processes run in
    # tests/test_torch_parallel_cli.py)
    with pytest.raises(ValueError, match="--process-id"):
        cli.main(["train", *DATA, "--coordinator", "localhost:1234",
                  "--num-processes", "2"])
    # benchmark measures the card: without one (and without --device cpu)
    # it refuses, naming the missing card, and prints no line
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["benchmark", "--quick"])
        # python -m boosted_detr_torch.cli runs main and exits with its code
        out = subprocess.run([sys.executable, "-m", "boosted_detr_torch.cli",
                              "benchmark"], capture_output=True, text=True,
                             timeout=120,
                             env=dict(os.environ, PYTHONPATH=str(ROOT)))
        assert out.returncode not in (0, 2) and out.stdout == ""
        assert "no CUDA card" in out.stderr
