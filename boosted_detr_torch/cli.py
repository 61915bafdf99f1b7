"""Command-line driver: ``python -m boosted_detr_torch.cli <cmd> ...``.

Counterpart of boosted_detr_tpu/cli.py, driving the same workflow from YAML
configs (``config.from_yaml`` and dotted overrides) over the port:

  train     - train DETR / BoostedDETR / DETRPanoptic on a COCO-format
              dataset directory or the built-in synthetic dataset, with
              checkpoints, a CSV log and ``--save``. ``--model pretrainer``
              drives the reference's pretrain -> transfer -> detect flow: a
              classifier pre-trainer shares the trunk, trains
              ``--pretrain-epochs``, transfers its weights, then detection
              training goes on.
  evaluate  - COCO-protocol mAP of a saved model on a dataset (``--pq``:
              Panoptic Quality of a panoptic model).
  export    - a standalone ``torch.export`` serving artifact from a saved
              model (optionally the early-exit program with a runtime
              threshold), for ``--platforms cuda`` (the default) or
              ``cpu``.
  benchmark - not ported: it waits for the port's benchmark (ROADMAP.md,
              Queue 1 item 6) and exits 2.

``train`` and ``evaluate`` run on ``--device`` (``cuda`` by default; pass
``--device cpu`` on a machine without a card). ``train --coordinator
HOST:PORT --num-processes N --process-id R`` is one process of a run
across N (one command each, parallel/multiprocess.py): the process group
is ``nccl`` on a card and ``gloo`` on the CPU unless ``--backend`` names
one, ``batch_size`` is per process, each process reads its stride of the
data, and every process prints the same ``final loss:``; rank 0 saves.

Examples:
  python -m boosted_detr_torch.cli train --synthetic --epochs 50 \\
      --set model.encoder_dim=64 --set train.batch_size=8
  python -m boosted_detr_torch.cli train --config cfg.yaml \\
      --dataset fashionpedia --data-dir /data/fashionpedia
  python -m boosted_detr_torch.cli train --synthetic \\
      --coordinator host0:1234 --num-processes 2 --process-id $RANK
"""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Dict, List


def _parse_sets(pairs: List[str]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for pair in pairs or []:
        key, _, raw = pair.partition("=")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def _build_data(args):
    from boosted_detr_torch.data import vocabularies
    from boosted_detr_torch.data.datasets import (COCOStandard, Fashionpedia,
                                                  SyntheticShapes)

    if args.synthetic:
        ds = SyntheticShapes(num_images=args.synthetic_images, image_size=64,
                             max_objects=3, seed=0)
        return ds, ds.dataframes("train"), ds.get_vocab()
    cls = {"coco": COCOStandard, "fashionpedia": Fashionpedia}[args.dataset]
    loader = cls(args.data_dir, args.data_dir + "/local")
    loader.get_data(download=args.download, unzip=args.download)
    df = loader.dataframes(args.subset)
    vocab = vocabularies.vocab_dict(
        "COCO" if args.dataset == "coco" else "Fashionpedia")
    return loader, df, vocab


def _build_model(args, vocab):
    from boosted_detr_torch import api
    from boosted_detr_torch import config as config_lib

    overrides = _parse_sets(args.set)
    if args.config:
        mcfg, tcfg = config_lib.from_yaml(args.config, **overrides)
    else:
        model_kw = {k.split(".", 1)[1]: v for k, v in overrides.items()
                    if k.startswith("model.")}
        train_kw = {k.split(".", 1)[1]: v for k, v in overrides.items()
                    if k.startswith("train.")}
        if "image_size" in model_kw:
            model_kw["image_size"] = tuple(model_kw["image_size"])
        mcfg = config_lib.ModelConfig(**model_kw)
        tcfg = config_lib.TrainConfig(**train_kw)
    if args.synthetic:
        mcfg = mcfg.replace(image_size=(64, 64), backbone="tiny",
                            compute_dtype="float32", max_objects=4,
                            dropout_rate=0.0)
        tcfg = tcfg.replace(optimizer="adamw", lr_schedule="constant",
                            clipnorm=0.0)
    if args.checkpoint_dir:
        tcfg = tcfg.replace(checkpoint_dir=args.checkpoint_dir)

    cls = {"boosted": api.BoostedDETR,
           "panoptic": api.DETRPanoptic}.get(args.model, api.DETR)
    geometry = dict(
        num_object_preds=mcfg.num_object_preds, image_size=mcfg.image_size,
        num_encoder_blocks=mcfg.num_encoder_blocks,
        num_encoder_heads=mcfg.num_encoder_heads,
        encoder_dim=mcfg.encoder_dim,
        num_decoder_blocks=mcfg.num_decoder_blocks,
        num_decoder_heads=mcfg.num_decoder_heads,
        decoder_dim=mcfg.decoder_dim,
        num_panoptic_heads=mcfg.num_panoptic_heads,
        panoptic_dim=mcfg.panoptic_dim)
    extra = dict(backbone=mcfg.backbone, backbone_width=mcfg.backbone_width,
                 compute_dtype=mcfg.compute_dtype,
                 max_objects=mcfg.max_objects, matcher=mcfg.matcher,
                 norm=mcfg.norm, dropout_rate=mcfg.dropout_rate,
                 use_pallas_attention=mcfg.use_pallas_attention)
    if args.model == "synthetic-tiny":
        geometry.update(num_object_preds=12, num_encoder_blocks=2,
                        num_encoder_heads=4, encoder_dim=64,
                        num_decoder_blocks=2, num_decoder_heads=4,
                        decoder_dim=64)
        cls = api.DETR
    model = cls(vocab_dict=vocab, device=args.device, **geometry, **extra)
    return model, tcfg


def cmd_train(args) -> int:
    feed = {"process_index": 0, "process_count": 1}
    if getattr(args, "coordinator", None):
        # one process of a multi-process run: batch_size is per process,
        # the global batch batch_size * num_processes
        from boosted_detr_torch.parallel import multiprocess

        if args.num_processes is None or args.process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        multiprocess.initialize(args.coordinator, args.num_processes,
                                args.process_id, backend=args.backend,
                                device=args.device)
        feed = multiprocess.feed_info()
    dataset, df, vocab = _build_data(args)
    model, tcfg = _build_model(args, vocab)
    pipe = model.make_pipeline(dataset=dataset if args.synthetic else None)

    def batches():
        return pipe.batches(df, batch_size=tcfg.batch_size, seed=0, **feed)

    sample = next(batches())
    model.compile(sample_batch=sample, train_config=tcfg)
    if args.pretrained_backbone:
        model.load_pretrained_backbone(args.pretrained_backbone)
        print(f"loaded pretrained backbone from {args.pretrained_backbone}")
    if args.model == "pretrainer" and args.pretrain_epochs > 0:
        # the reference's pretrain -> transfer flow (DETR_COCO.ipynb cells
        # 26/32): a multi-label classifier shares the detector's trunk
        from boosted_detr_torch import api

        clf = api.DETR_MultiClassifier(model, vocab)
        clf.compile(train_config=tcfg, sample_batch=sample)
        clf.fit(batches, epochs=args.pretrain_epochs)
        clf.transfer_to_base()
        print(f"pre-trained {args.pretrain_epochs} epochs; trunk "
              "transferred to the detector")
    history = model.fit(batches, epochs=args.epochs, log_path=args.log_csv,
                        tensorboard_dir=args.tensorboard,
                        scan_steps=args.scan_steps)
    print(f"final loss: {history['loss'][-1]:.4f}")
    if args.eval_map:
        from boosted_detr_torch.train import metrics as metrics_lib

        # quality is measured on the held-out val split; drop_remainder=
        # False: a val split smaller than (or not divisible by) the batch
        # size must still evaluate every image
        val_df = _val_dataframe(args, dataset, df)
        result = metrics_lib.evaluate_map(
            model.trainer, pipe.batches(val_df, batch_size=tcfg.batch_size,
                                        shuffle=False,
                                        drop_remainder=False))
        print(f"val mAP: {result['mAP']:.4f}  mAP50: {result['mAP50']:.4f}")
    if args.save:  # every rank: rank 0 writes behind a barrier
        model.save(args.save)
        print(f"saved model to {args.save}")
    return 0


def _val_dataframe(args, dataset, train_df):
    """The held-out split for --eval-map; warns and falls back to train when
    the dataset has no val subset."""
    try:
        return dataset.dataframes("val")
    except Exception as exc:  # noqa: BLE001 - any missing-subset failure
        print(f"WARNING: no val subset available ({exc}); evaluating mAP on "
              "the TRAINING split - this measures memorization")
        return train_df


def cmd_evaluate(args) -> int:
    from boosted_detr_torch import api
    from boosted_detr_torch.train import metrics as metrics_lib

    dataset, df, _ = _build_data(args)
    model = api.load_model(args.load, device=args.device)
    pipe = model.make_pipeline(dataset=dataset if args.synthetic else None)
    result = metrics_lib.evaluate_map(
        model.trainer,
        pipe.batches(df, batch_size=args.batch_size, shuffle=False),
        use_ema=args.use_ema)
    print(f"mAP: {result['mAP']:.4f}  mAP50: {result['mAP50']:.4f} "
          f"mAP75: {result['mAP75']:.4f}")
    if args.pq:
        # Panoptic Quality (panoptic family only): the pipeline must emit
        # mask targets, which api.DETRPanoptic.make_pipeline does by default
        if "masks" not in next(pipe.batches(df, batch_size=1,
                                            shuffle=False)):
            print("ERROR: --pq needs a panoptic model (mask targets); "
                  f"loaded model class is {type(model).__name__}")
            return 2
        pq = metrics_lib.evaluate_pq(
            model.trainer,
            pipe.batches(df, batch_size=args.batch_size, shuffle=False),
            use_ema=args.use_ema)
        print(f"PQ: {pq['PQ']:.4f}  SQ: {pq['SQ']:.4f}  "
              f"RQ: {pq['RQ']:.4f}  ({pq['num_categories']} categories)")
    return 0


def cmd_export(args) -> int:
    """Saved model directory -> standalone serving artifact for the device
    ``--platforms`` names (the model is loaded there)."""
    from boosted_detr_torch import api, serving

    model = api.load_model(args.load, device=args.platforms)
    serving.export_serving(model.trainer, args.out,
                           platforms=args.platforms,
                           early_exit=args.early_exit,
                           exit_criterion=args.exit_criterion,
                           use_ema=args.use_ema)
    kind = (f"early-exit ({args.exit_criterion}, runtime threshold)"
            if args.early_exit else "standard")
    print(f"exported {kind} serving artifact for {args.platforms} to "
          f"{args.out}")
    return 0


def cmd_benchmark(args) -> int:
    print("benchmark: the port has no benchmark yet; it waits for "
          "ROADMAP.md, Queue 1 item 6 (bench_torch.py and its cells)",
          file=sys.stderr)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="boosted_detr_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_data_args(p):
        p.add_argument("--synthetic", action="store_true")
        p.add_argument("--synthetic-images", type=int, default=32)
        p.add_argument("--dataset", choices=["coco", "fashionpedia"],
                       default="fashionpedia")
        p.add_argument("--data-dir", default="/tmp/data")
        p.add_argument("--download", action="store_true")
        p.add_argument("--subset", default="train")
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (cuda, or cpu)")

    t = sub.add_parser("train")
    add_data_args(t)
    t.add_argument("--model",
                   choices=["detr", "boosted", "panoptic", "pretrainer",
                            "synthetic-tiny"],
                   default="detr")
    t.add_argument("--config", help="YAML config path")
    t.add_argument("--set", action="append", metavar="model.key=value",
                   help="dotted config overrides")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--pretrain-epochs", type=int, default=1,
                   help="classifier pre-training epochs before the transfer "
                        "(--model pretrainer only)")
    t.add_argument("--pretrained-backbone", metavar="PATH",
                   help="npz / torchvision state-dict with ImageNet ResNet "
                        "weights to import into the backbone")
    t.add_argument("--scan-steps", type=int, default=1,
                   help="group N consecutive steps, their losses read back "
                        "once a group")
    t.add_argument("--checkpoint-dir")
    t.add_argument("--log-csv")
    t.add_argument("--tensorboard")
    t.add_argument("--eval-map", action="store_true")
    t.add_argument("--save", help="directory to save the whole model")
    t.add_argument("--coordinator", metavar="HOST:PORT",
                   help="this process's rendezvous for a run across "
                        "--num-processes processes (torch.distributed)")
    t.add_argument("--num-processes", type=int)
    t.add_argument("--process-id", type=int)
    t.add_argument("--backend", choices=["nccl", "gloo"],
                   help="the process group's backend (default: nccl on a "
                        "card, gloo on the CPU)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate")
    e.add_argument("--pq", action="store_true",
                   help="also report Panoptic Quality (PQ/SQ/RQ; panoptic "
                        "models only)")
    e.add_argument("--use-ema", action="store_true",
                   help="evaluate the EMA shadow weights "
                        "(TrainConfig.ema_decay)")
    add_data_args(e)
    e.add_argument("--load", required=True, help="saved model directory")
    e.add_argument("--batch-size", type=int, default=8)
    e.set_defaults(fn=cmd_evaluate)

    x = sub.add_parser("export")
    x.add_argument("--load", required=True, help="saved model directory")
    x.add_argument("--out", required=True, help="artifact output directory")
    x.add_argument("--platforms", default="cuda", choices=["cuda", "cpu"],
                   help="the device the artifact runs on")
    x.add_argument("--use-ema", action="store_true",
                   help="export the EMA shadow weights")
    x.add_argument("--early-exit", action="store_true",
                   help="export the adaptive-depth program (the artifact "
                        "takes a runtime threshold)")
    x.add_argument("--exit-criterion", default="confidence",
                   choices=["confidence", "stability"],
                   help="early-exit rule: confidence floor, or PABEE-style "
                        "inter-block stability (the one that works on the "
                        "boosted ensemble's cumulative outputs)")
    x.set_defaults(fn=cmd_export)

    b = sub.add_parser("benchmark")
    b.add_argument("--quick", action="store_true")
    b.set_defaults(fn=cmd_benchmark)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
