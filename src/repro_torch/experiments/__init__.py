"""The paper's own experiments on the port: :mod:`repro_torch.experiments.table1`
(Table 1, the counterpart of ``benchmarks/bench_table1.py``)."""
