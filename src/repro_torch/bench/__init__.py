"""The port's paper benchmarks (ROADMAP: port benchmarks live here, not in
``benchmarks/``).  ``common.train_fc`` is the twin of
``benchmarks/common.py::train_fc``; ``table1_large_batch`` the twin of
``benchmarks/table1_large_batch.py``:

    PYTHONPATH=src python -m repro_torch.bench.table1_large_batch
    PYTHONPATH=src python -m repro_torch.bench.table1_large_batch --device cpu
"""
