"""Command-line entry points, the counterparts of the JAX package's
``cli/``: ``train``, ``infer``, ``grid_search`` and ``convert_weights``,
each run as ``python -m vision_collision_detection_tpu_torch.cli.<name>``.
Each takes the JAX command's flags with the same defaults, and ``--device``
(default the card; ``cpu`` for the CPU), the counterpart of
``JAX_PLATFORMS``.

There is no ``enable_compile_cache``: the JAX package keeps XLA's
compilations across restarts, but the port compiles nothing at start-up.
Its kernels are built once per source hash into ``build/torch_kernels/``
(``ops/_build.py``) and loaded from there by every later process."""
