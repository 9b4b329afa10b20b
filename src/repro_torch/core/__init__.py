"""repro_torch.core — the port of :mod:`repro.core`: the Algorithm-1 guard
(``byzantine_sgd``), its dense and fused backends, the key-free static
attacks (ALIE included), the baseline aggregators and the convex driver
``run_sgd``."""
