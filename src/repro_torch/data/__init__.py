"""repro_torch.data — the port of :mod:`repro.data` (the generated problem)."""
