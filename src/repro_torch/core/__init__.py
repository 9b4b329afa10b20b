"""repro_torch.core — the port of :mod:`repro.core`: the Algorithm-1 guard
(``byzantine_sgd``), its dense and fused backends, the static attacks, the
mean baseline and the convex driver ``run_sgd``."""
