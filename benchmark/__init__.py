"""The benchmark of the PyTorch and CUDA port
(``vision_collision_detection_tpu_torch``) on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once (``run.py``). The harness is
driven by data: a configuration is a file under ``configs/`` whose
``architecture`` names a module under ``architectures/`` (its parameters,
its reference forward, its FLOPs and kernel launches, its CPU test size),
a traffic mix a file under ``traffic/`` (read by the driver its ``kind``
names, ``serve.py`` or ``train.py``), a metric a file under ``metrics/``.
The yardstick lives here too: the traffic generator and the clip pool
(``harness.py``), the trace's reduction (``trace.py``), the peaks and the
operation and byte counts (``counts.py``), the plain reference
(``reference/`` and ``architectures/``) and the comparisons that decide
``correct`` (in the drivers). ``control.py`` reads, on the card, the readings the limits are
set from. Nothing here imports JAX or the JAX package; the reference
imports nothing of the program. Tests: ``python -m pytest benchmark/tests``.
"""
