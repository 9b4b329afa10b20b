"""repro_torch.models — the counterpart of :mod:`repro.models`: the dense
decoder (GQA / sliding-window attention, SwiGLU MLP) for training.

Entry point: :func:`repro_torch.models.model.build_model` returns a
:class:`LanguageModel` bundle (param defs, ``init``, ``forward``,
``loss_fn``); the other families and serving wait for later slices
(``ROADMAP.md`` §1 item 8).
"""
from repro_torch.models.model import LanguageModel, build_model

__all__ = ["LanguageModel", "build_model"]
