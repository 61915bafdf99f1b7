"""Training across processes end to end on the CPU, each rank a process of
its own (gloo, one thread, meeting at a ``file://`` store in ``tmp_path``,
importing no JAX):

- two ``python -m boosted_detr_torch.cli train --coordinator ...``
  processes, each reading its stride of the synthetic data, print the
  same ``final loss:`` (tests/test_profiling_multihost.py's two-process
  CLI run, on the ``synthetic-tiny`` model), and ``--save`` on both
  writes one directory that loads;
- two processes through the ``api`` and the Trainer beyond a plain fit:
  ``scan_steps=2``, ``evaluate``, ``evaluate_map`` and a checkpoint that
  rank 0 writes and a fresh Trainer on every rank restores;
- ``parallel/dryrun.py`` on four processes (data 2 x model 2): every
  family's tensor- and data-parallel step equals its one-process step.
"""

import re

import numpy as np
import pytest
import torch

from boosted_detr_torch.parallel import dryrun


def _cli(rank, n, init):
    return ["-m", "boosted_detr_torch.cli", "train", "--synthetic",
            "--synthetic-images", "8", "--model", "synthetic-tiny",
            "--epochs", "2", "--set", "train.batch_size=2", "--device",
            "cpu", "--coordinator", init, "--num-processes", str(n),
            "--process-id", str(rank)]


def test_two_cli_processes_print_the_same_final_loss(tmp_path):
    """``spawn`` raises unless both ranks exit 0, the save's barrier
    included."""
    init = (tmp_path / "store").as_uri()
    save = str(tmp_path / "saved")
    outs = dryrun.spawn([_cli(r, 2, init) + ["--save", save]
                         for r in range(2)], timeout=120)
    losses = [re.search(r"final loss: ([\d.]+)", out) for out in outs]
    assert all(losses), outs[0][-1500:]
    assert losses[0].group(1) == losses[1].group(1)
    assert all(f"saved model to {save}" in out for out in outs)
    from boosted_detr_torch import api

    model = api.load_model(save, device="cpu")
    image = torch.zeros(1, *model.config.image_size, 3)
    boxes = model.trainer.predict(image, decode_text=False)["boxes"]
    assert np.isfinite(np.asarray(boxes)).all()


_FULL_WORKER = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
rank, init, ckpt = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from boosted_detr_torch.parallel import multiprocess
multiprocess.initialize(init, 2, rank, device="cpu")
from boosted_detr_torch import api
from boosted_detr_torch.config import TrainConfig
from boosted_detr_torch.data.datasets import SyntheticShapes
from boosted_detr_torch.train import metrics as metrics_lib

KW = dict(num_object_preds=8, image_size=(32, 32), num_encoder_blocks=1,
          num_encoder_heads=2, encoder_dim=16, num_decoder_blocks=2,
          num_decoder_heads=2, decoder_dim=16, backbone='tiny',
          backbone_width=0.25, compute_dtype='float32', max_objects=3,
          dropout_rate=0.0)
ds = SyntheticShapes(num_images=8, image_size=32, max_objects=2, seed=0)
df = ds.dataframes('train')
feed = multiprocess.feed_info()
model = api.DETR(vocab_dict=ds.get_vocab(), device='cpu', **KW)
pipe = model.make_pipeline(dataset=ds)
sample = next(pipe.batches(df, batch_size=2, seed=0, **feed))
tcfg = TrainConfig(optimizer='adamw', lr_schedule='constant', clipnorm=0.0,
                   batch_size=2, checkpoint_dir=ckpt)
model.compile(sample_batch=sample, train_config=tcfg)
hist = model.fit(lambda: pipe.batches(df, batch_size=2, seed=0, **feed),
                 epochs=2, scan_steps=2, checkpoint_every_epochs=10)
print(f'FIT_LOSS {hist["loss"][-1]:.6f}')
ev = model.trainer.evaluate(
    pipe.batches(df, batch_size=2, shuffle=False, **feed))
print(f'EVAL_LOSS {ev["loss"]:.6f}')
r = metrics_lib.evaluate_map(
    model.trainer, pipe.batches(df, batch_size=2, shuffle=False))
print(f'MAP50 {r["mAP50"]:.6f}')
model.trainer.save(wait=True)
step_before = int(model.trainer.state.step)
model2 = api.DETR(vocab_dict=ds.get_vocab(), device='cpu', **KW)
model2.compile(sample_batch=sample, train_config=tcfg)
print(f'RESTORED {int(model2.trainer.state.step)} OF {step_before}')
p1 = model.trainer.predict(sample['image'], decode_text=False)
p2 = model2.trainer.predict(sample['image'], decode_text=False)
assert np.array_equal(p1['boxes'], p2['boxes'])
print('CKPT_ROUNDTRIP_OK')
"""


def test_two_processes_scan_eval_map_checkpoint(tmp_path):
    init = (tmp_path / "store").as_uri()
    ckpt = str(tmp_path / "ckpt")
    outs = dryrun.spawn([["-c", _FULL_WORKER, str(r), init, ckpt]
                         for r in range(2)], timeout=120)
    for out in outs:
        assert "CKPT_ROUNDTRIP_OK" in out, out[-3000:]
    for key in ("FIT_LOSS", "EVAL_LOSS", "MAP50", "RESTORED"):
        vals = [re.search(rf"{key} (.+)", out).group(1) for out in outs]
        assert vals[0] == vals[1], (key, vals)
    step = re.search(r"RESTORED (\d+) OF (\d+)", outs[0])
    assert step.group(1) == step.group(2) != "0"


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    return dryrun.dryrun(4, work_dir=str(tmp_path_factory.mktemp("dry")))


def test_dryrun_runs_every_family_on_four_processes(dry_run):
    """``dryrun`` raises unless every family's loss, gradients and new
    parameters across the four processes equal its one-process step's
    (``dryrun.LOSS_RTOL``, ``dryrun.GRAD_TOL``) and every data replica
    holds the same bits; it reports each family's largest differences."""
    assert list(dry_run) == list(dryrun.FAMILIES)
    for name, errs in dry_run.items():
        assert set(errs) == {"loss", "grads", "params"}, name
