"""The port's paper benchmarks (ROADMAP: port benchmarks live here, not in
``benchmarks/``).  ``common.train_fc`` is the twin of
``benchmarks/common.py::train_fc`` (``fault_plan`` trains an elastic
fleet under a ``Supervisor``); each other module is the twin of the
reference script of its name, with the same columns and the same summary
row ``name,us_per_call,derived``:

  * ``table1_large_batch`` — Table 1, with the ``ssgd_autolr`` column;
  * ``fig2_effective_lr`` — Fig. 2: SSGD, DPSGD and SSGD*, diagnostics and
    probes, SSGD*'s noise sweep;
  * ``ablation_topology`` — every gossip schedule, fused, against its
    spectral-gap bound;
  * ``table4_lr_tuning`` — Table 4: SSGD and DPSGD over four lrs;
  * ``fig4_noise_decomp`` — Fig. 4: Delta_S against Delta2;
  * ``theorem1_smoothing`` — Theorem 1's 2G/sigma smoothing bound;
  * ``table5_asr_proxy`` — Table 5's ASR proxy: 100 zipf classes, SSGD
    and DPSGD over an lr scan.
  * ``fig3_straggler`` — Fig. 3: synchronous DPSGD against AD-PSGD with a
    straggler injected through ``FaultPlan`` (the elastic fleet).

Each runs on the card unless told otherwise, and takes ``--smoke``:

    PYTHONPATH=src python -m repro_torch.bench.<name>
    PYTHONPATH=src python -m repro_torch.bench.<name> --device cpu --smoke
"""
