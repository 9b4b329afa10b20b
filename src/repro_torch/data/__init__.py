"""repro_torch.data — the port of :mod:`repro.data.problems`: the
generated, quadratic, least-squares and logistic problems."""
