"""repro_torch.launch — drivers (the counterpart of :mod:`repro.launch`):
:mod:`repro_torch.launch.train`."""
