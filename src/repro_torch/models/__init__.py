"""repro_torch.models — the counterpart of :mod:`repro.models`: the dense
decoders (GQA / sliding-window attention, SwiGLU MLP), the MoE
feed-forward (:mod:`.moe`) and the Mamba2/SSD mixer (:mod:`.ssm`), for
training and serving.

Entry point: :func:`repro_torch.models.model.build_model` returns a
:class:`LanguageModel` bundle (param defs, ``init``, ``forward``,
``loss_fn``, ``prefill``, ``init_cache``, ``decode_step``); MLA and the
encoder–decoder wait for later slices (``ROADMAP.md`` §1 item 8).
"""
from repro_torch.models.model import LanguageModel, build_model

__all__ = ["LanguageModel", "build_model"]
