"""Observability, the counterpart of :mod:`repro.obs`.  Ported so far:
:mod:`repro_torch.obs.provenance`."""
from repro_torch.obs.provenance import provenance_meta

__all__ = ["provenance_meta"]
