"""repro_torch.core — the port of :mod:`repro.core`: the Algorithm-1 guard
(``byzantine_sgd``, with the generating step ``gen_step``), its four
backends, the key-free attacks (ALIE included), the baseline aggregators
and the convex driver ``run_sgd``."""
