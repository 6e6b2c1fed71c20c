"""PyTorch + CUDA port of the dashcam collision-detection framework.

Classifies 5-second dashcam clips into Normal / Near Collision / Collision
with a per-frame ConvNeXt backbone, a bidirectional GRU over time and an MLP
classifier. The layout mirrors ``vision_collision_detection_tpu`` module for
module; the hot operations run as hand-written CUDA kernels for Hopper
(``ops/csrc``), each beside a plain PyTorch version of the same function.

This package imports ``torch`` and never JAX or the JAX package.
"""

from vision_collision_detection_tpu_torch.version import __version__

CLASS_NAMES = ("Normal", "Near Collision", "Collision")
CLASS_TO_INDEX = {name: i for i, name in enumerate(CLASS_NAMES)}

__all__ = ["__version__", "CLASS_NAMES", "CLASS_TO_INDEX"]
