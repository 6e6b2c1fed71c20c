"""The benchmark's plain reference: float32 PyTorch, written from the
configurations' published descriptions, with no kernel, cache or batching
of the program under test.

- ``models``: a configuration's forward as a function of a parameter dict,
  its architecture's (``benchmark/architectures/``: the flagship's
  ConvNeXt-T, bidirectional GRU and classifier MLP, the scaled ViViT),
  and the layers the architectures share;
- ``weights``: each configuration's parameters (the program's state-dict
  names and shapes, from its architecture) and their seeded laws;
- ``preprocess``: K1's dequantise-normalise-pad, and a frozen copy of the
  training preprocess with its draw order (flip, letterbox, augmentation);
- ``training``: the weighted loss, AdamW with its schedule, the loader's
  shuffle and the step seeds, and the replay of a training cell's first
  steps;
- ``products``: how the products are computed: float32 with TF32 off, or,
  for the control, with every operand rounded to fp8.

Nothing here imports ``jax``, the JAX package or the program.
"""
