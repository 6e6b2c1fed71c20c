"""Grid search over backbone × temporal mode × learning rate.

Counterpart of ``vision_collision_detection_tpu/cli/grid_search.py``: each
combination is a whole ``Trainer`` run; the best validation metrics go into
a summary CSV and a plot, and the last line of standard output is one JSON
object with the winner::

  python -m vision_collision_detection_tpu_torch.cli.grid_search \\
      --synthetic 4 --epochs 2 \\
      --backbones resnet18 convnext_tiny --temporal-modes gru attention \\
      --learning-rates 1e-4 3e-4 [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

from vision_collision_detection_tpu_torch.cli.train import (
    build_parser as build_train_parser,
    config_from_args,
    load_datasets,
    pick_strategy,
)


def build_parser() -> argparse.ArgumentParser:
    p = build_train_parser()
    p.description = "Grid search over model/temporal/LR combinations"
    p.add_argument("--backbones", nargs="+",
                   default=["resnet18", "convnext_tiny"])
    p.add_argument("--temporal-modes", nargs="+",
                   default=["gru", "attention", "conv"])
    p.add_argument("--learning-rates", nargs="+", type=float,
                   default=[1e-4, 3e-4])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    strategy = pick_strategy(args)
    base_cfg = config_from_args(args)
    train_ds, val_ds, test_ds = load_datasets(args, base_cfg)

    from vision_collision_detection_tpu_torch.train import Trainer

    results = []
    grid = list(itertools.product(
        args.backbones, args.temporal_modes, args.learning_rates
    ))
    for i, (backbone, temporal, lr) in enumerate(grid):
        name = f"{backbone}_{temporal}_lr{lr:g}"
        print(f"[grid {i + 1}/{len(grid)}] {name}", file=sys.stderr)
        cfg = base_cfg.override({
            "model.backbone": backbone,
            "model.temporal_mode": temporal,
            "optim.learning_rate": lr,
            "experiment_name": name,
        })
        trainer = Trainer(cfg, train_ds, val_ds, test_ds, strategy=strategy,
                          device=args.device)
        trainer.train()
        row = {
            "experiment": name, "backbone": backbone,
            "temporal_mode": temporal, "learning_rate": lr,
            "best_val_loss": trainer.best_val_loss,
        }
        if trainer.history.records:
            last = trainer.history.records[-1]
            for k in ("val_accuracy", "val_auc", "val_weighted_f1"):
                if k in last:
                    row[k] = last[k]
        results.append(row)

    import pandas as pd

    df = pd.DataFrame(results).sort_values("best_val_loss")
    out = os.path.join(base_cfg.save_dir, "grid_search_results.csv")
    os.makedirs(base_cfg.save_dir, exist_ok=True)
    df.to_csv(out, index=False)
    try:
        from vision_collision_detection_tpu_torch.obs.plots import (
            plot_grid_search,
        )

        plot_grid_search(
            df, os.path.join(base_cfg.save_dir, "grid_search.png")
        )
    except Exception as e:  # the plot is optional (no matplotlib on the card)
        print(f"grid plot failed: {e}", file=sys.stderr)
    best = df.iloc[0].to_dict()
    # one line, last, so that scripts and tests can parse it
    print(json.dumps({"best": best, "summary_csv": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
