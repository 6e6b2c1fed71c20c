"""Training from the command line.

Counterpart of ``vision_collision_detection_tpu/cli/train.py``, with its
flags. One process trains on one device; under ``torchrun`` each process
drives its rank's card, and the batch is sharded over the data group
(``--batch-size`` is per device)::

  python -m vision_collision_detection_tpu_torch.cli.train \\
      --metadata-csv data.csv --backbone convnext_tiny --temporal-mode gru \\
      --epochs 15 --batch-size 8 [--synthetic N] [--test] [--device cpu]
  torchrun --nproc-per-node 4 -m vision_collision_detection_tpu_torch.cli.train ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="collision-detection training")
    # data
    p.add_argument("--metadata-csv", default="", help="metadata CSV path")
    p.add_argument("--video-dirs", nargs="*", default=[],
                   help="base dirs to scan when CSV has no video_path column")
    p.add_argument("--split-column", default="split")
    p.add_argument("--video-path-column", default="video_path")
    p.add_argument("--label-column", default="video_type")
    p.add_argument("--id-column", default="id")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--duration", type=int, default=5)
    p.add_argument("--frame-size", type=int, default=224)
    p.add_argument("--sample-strategy", default="random",
                   choices=["random", "center", "metadata_time", "uniform"])
    p.add_argument("--load-sensor", action="store_true")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="generate N clips/class of synthetic data (smoke runs)")
    # model
    p.add_argument("--backbone", "--base-model", dest="backbone",
                   default="convnext_tiny")
    p.add_argument("--temporal-mode", default="gru",
                   choices=["attention", "conv", "pooling", "rnn", "lstm", "gru"])
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--pretrained-path", default="",
                   help="converted torchvision weights (.npz)")
    # optimization
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch-size", type=int, default=8, help="per device")
    p.add_argument("--learning-rate", "--lr", dest="lr", type=float,
                   default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--loss-type", default="cross_entropy",
                   choices=["cross_entropy", "bce"])
    p.add_argument("--no-class-weights", action="store_true")
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--validation-freq", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--dashboard", action="store_true",
                   help="live console+HTML training dashboard")
    # experiment
    p.add_argument("--save-dir", default="runs")
    p.add_argument("--experiment-name", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--test", action="store_true", help="run test() after train")
    # parallel
    p.add_argument("--data-parallel", action="store_true",
                   help="data parallelism over the torchrun ranks (auto "
                        "when there is more than one)")
    p.add_argument("--single-device", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, under torchrun the "
                        "rank's; 'cpu' for the CPU)")
    return p


def config_from_args(args):
    from vision_collision_detection_tpu_torch.config import ExperimentConfig

    return ExperimentConfig().override({
        "data.fps": args.fps,
        "data.duration": args.duration,
        "data.frame_size": args.frame_size,
        "data.sample_strategy": args.sample_strategy,
        "data.load_sensor_data": args.load_sensor,
        "data.batch_size": args.batch_size,
        "data.num_workers": args.num_workers,
        "data.seed": args.seed,
        "model.backbone": args.backbone,
        "model.temporal_mode": args.temporal_mode,
        "model.dropout": args.dropout,
        "model.pretrained_path": args.pretrained_path,
        "optim.learning_rate": args.lr,
        "optim.weight_decay": args.weight_decay,
        "optim.loss_type": args.loss_type,
        "optim.use_class_weights": not args.no_class_weights,
        "train.epochs": args.epochs,
        "train.patience": args.patience,
        "train.validation_freq": args.validation_freq,
        "train.seed": args.seed,
        "train.resume": args.resume,
        "train.dashboard": args.dashboard,
        "augment.enabled": not args.no_augment,
        "experiment_name": args.experiment_name,
        "save_dir": args.save_dir,
        "metadata_csv": args.metadata_csv,
    })


def load_datasets(args, cfg):
    """(train, val, test) datasets from ``--synthetic`` clips, or from the
    metadata CSV (with ``--video-dirs``, found by scanning them)."""
    import pandas as pd

    from vision_collision_detection_tpu_torch.data import (
        create_datasets_from_directories,
        create_datasets_with_manual_split,
    )

    if args.synthetic:
        from vision_collision_detection_tpu_torch.media.synthetic import (
            generate_dataset,
        )

        out = os.path.join(cfg.save_dir, "_synthetic_data")
        # split order guarantees val/test coverage even at 3 clips/class
        csv = generate_dataset(
            out, clips_per_class=args.synthetic, num_frames=cfg.data.num_frames,
            fps=cfg.data.fps, splits=("train", "val", "test", "train", "train"),
        )
        df = pd.read_csv(csv).fillna({"sensor_path": ""})
        return create_datasets_with_manual_split(
            df, fps=cfg.data.fps, duration=cfg.data.duration,
            frame_size=cfg.data.frame_size,
            train_strategy=cfg.data.sample_strategy,
            load_sensor=cfg.data.load_sensor_data, seed=cfg.data.seed,
        )

    if not args.metadata_csv:
        raise SystemExit("--metadata-csv (or --synthetic N) is required")
    df = pd.read_csv(args.metadata_csv)
    common = dict(
        fps=cfg.data.fps, duration=cfg.data.duration,
        frame_size=cfg.data.frame_size,
        train_strategy=cfg.data.sample_strategy,
        load_sensor=cfg.data.load_sensor_data, seed=cfg.data.seed,
    )
    if args.video_dirs:
        return create_datasets_from_directories(
            df, args.video_dirs, id_column=args.id_column,
            label_column=args.label_column, **common,
        )
    return create_datasets_with_manual_split(
        df, split_column=args.split_column,
        video_path_column=args.video_path_column,
        label_column=args.label_column, id_column=args.id_column,
        **common,
    )


def pick_strategy(args):
    """Under ``torchrun``, join the process group; then data parallelism
    over every rank when there is more than one or ``--data-parallel`` is
    given, else one device. ``VCD_NUM_DATA`` (set by
    ``scripts/run_training.sh distributed N``), where set, must equal the
    world size: a data group narrower than the world would leave ranks
    idle, so it raises rather than drop them."""
    import torch.distributed as dist

    from vision_collision_detection_tpu_torch.config import MeshConfig
    from vision_collision_detection_tpu_torch.parallel import (
        DataParallelStrategy,
        create_mesh,
        maybe_initialize_distributed,
    )
    from vision_collision_detection_tpu_torch.train import SingleDeviceStrategy

    maybe_initialize_distributed()
    if args.single_device:
        return SingleDeviceStrategy()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.data_parallel or world > 1:
        n = int(os.environ.get("VCD_NUM_DATA", "0") or 0)
        if n and n != world:
            raise ValueError(
                f"VCD_NUM_DATA={n} but torchrun started {world} processes: "
                f"launch {n} processes (--nproc-per-node {n})")
        return DataParallelStrategy(create_mesh(MeshConfig(num_data=world,
                                                           num_model=1)))
    return SingleDeviceStrategy()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    strategy = pick_strategy(args)
    train_ds, val_ds, test_ds = load_datasets(args, cfg)

    from vision_collision_detection_tpu_torch.train import Trainer

    trainer = Trainer(cfg, train_ds, val_ds, test_ds, strategy=strategy,
                      device=args.device)
    trainer.train()
    if args.test:
        metrics = trainer.test()
        printable = {k: v for k, v in metrics.items()
                     if not k.startswith("_") and k != "ids"}
        print(json.dumps(printable, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
