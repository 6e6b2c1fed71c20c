"""Offline weight conversion: torch ``.pth`` → flax-layout ``.npz``.

Counterpart of ``vision_collision_detection_tpu/cli/convert_weights.py``,
writing the same files. Two modes:

1. Backbone (default): a torchvision ImageNet ``state_dict`` → the
   backbone's ``.npz`` for ``--pretrained-path`` (``cli.train``) or
   ``ModelConfig.pretrained_path``::

     python -m vision_collision_detection_tpu_torch.cli.convert_weights \\
         --torch-checkpoint convnext_tiny-983f1562.pth \\
         --backbone convnext_tiny --output convnext_tiny_imagenet.npz

2. ``--full``: a whole reference training checkpoint (``model_state_dict``
   and ``hyperparams``) → the model's ``.npz`` and a
   ``.npz.hyperparams.json`` sidecar, served with
   ``CollisionPredictor.from_torch_checkpoint``::

     python -m vision_collision_detection_tpu_torch.cli.convert_weights \\
         --torch-checkpoint best_model.pth --full --output model.npz

It runs on the CPU and needs no card.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="torch → flax-layout weights")
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--backbone",
                   help="torchvision backbone name (backbone mode)")
    p.add_argument("--full", action="store_true",
                   help="convert a full reference training checkpoint "
                        "(backbone + temporal head + classifier)")
    p.add_argument("--output", required=True)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

    if args.full:
        from vision_collision_detection_tpu_torch.models.import_torch import (
            import_checkpoint_file,
        )

        hp, _ = import_checkpoint_file(args.torch_checkpoint, args.output)
        print(f"wrote {args.output} + {args.output}.hyperparams.json "
              f"({hp['base_model']} + {hp['temporal_mode']}, "
              f"{hp['num_classes']} classes)")
        return 0

    if not args.backbone:
        p.error("--backbone is required unless --full is given")
    from vision_collision_detection_tpu_torch.models.convert import (
        convert_checkpoint_file,
    )

    out = convert_checkpoint_file(args.torch_checkpoint, args.backbone,
                                  args.output)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
