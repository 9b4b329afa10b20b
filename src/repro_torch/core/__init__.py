"""repro_torch.core — the port of :mod:`repro.core`: the Algorithm-1 guard
(``byzantine_sgd``, with the generating step ``gen_step``), its four
backends, the attack zoo and its combinators, the baseline aggregators,
the convex driver ``run_sgd`` with ``ByzantineSGDSolver``, the Section-4
``epoch_solver`` and the Section-5 ``lower_bound`` experiments."""
