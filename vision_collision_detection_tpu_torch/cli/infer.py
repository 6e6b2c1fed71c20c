"""Inference: a checkpoint → predictions for video files or directories.

Counterpart of ``vision_collision_detection_tpu/cli/infer.py``, with
sliding-window mode for long videos::

  python -m vision_collision_detection_tpu_torch.cli.infer \\
      --checkpoint runs/convnext_tiny_gru [--sliding] \\
      --videos clip1.mp4 dir_of_clips/ [--output preds.json] [--display] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="collision-detection inference")
    p.add_argument("--checkpoint", required=True,
                   help="run dir or checkpoint dir")
    p.add_argument("--videos", nargs="+", required=True,
                   help="video files and/or directories")
    p.add_argument("--sample-strategy", default="center",
                   choices=["random", "center", "metadata_time", "uniform"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--sliding", action="store_true",
                   help="sliding-window mode (one video at a time)")
    p.add_argument("--stride-sec", type=float, default=1.0)
    p.add_argument("--output", default="", help="write JSON results here")
    p.add_argument("--csv", default="", help="write CSV results here")
    p.add_argument("--display", action="store_true", help="ANSI prob bars")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vision_collision_detection_tpu_torch.infer.predictor import (
        CollisionPredictor,
    )

    pred = CollisionPredictor.from_checkpoint(args.checkpoint,
                                              device=args.device)

    if args.sliding:
        results = []
        for v in args.videos:
            results.extend(
                dict(video_path=v, **r)
                for r in pred.predict_sliding(v, stride_sec=args.stride_sec)
            )
    else:
        paths = []
        for v in args.videos:
            paths.extend(pred._collect_paths(v))
        results = pred.predict(
            paths, sample_strategy=args.sample_strategy,
            batch_size=args.batch_size,
        )

    if args.display and not args.sliding:
        CollisionPredictor.display_results(results)
    else:
        print(json.dumps(results, indent=2))

    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    if args.csv:
        import pandas as pd

        flat = []
        for r in results:
            row = {k: v for k, v in r.items() if k != "probabilities"}
            for cls, prob in r.get("probabilities", {}).items():
                row[f"prob_{cls.lower().replace(' ', '_')}"] = prob
            flat.append(row)
        pd.DataFrame(flat).to_csv(args.csv, index=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
