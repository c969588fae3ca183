"""portbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one cell, configuration, traffic mix, traffic
kind, per-layer metric or kernel roofline is a file of its own under this
folder, found by its name (``spec.py``).  Nothing here imports ``jax`` or
the JAX package; the plain references under ``reference/`` import only
``torch`` and ``numpy``.
"""
