"""repro_torch.models — the counterpart of :mod:`repro.models`: the dense
decoders (GQA / sliding-window attention, SwiGLU MLP), MLA, the MoE
feed-forward (:mod:`.moe`), the Mamba2/SSD mixer (:mod:`.ssm`), the
encoder–decoder and the frontends, for training and serving.

Entry point: :func:`repro_torch.models.model.build_model` returns a
:class:`LanguageModel` bundle (param defs, ``init``, ``forward``,
``loss_fn``, ``prefill``, ``init_cache``, ``decode_step``) for every
config of :mod:`repro_torch.configs`.
"""
from repro_torch.models.model import LanguageModel, build_model

__all__ = ["LanguageModel", "build_model"]
