"""InternVL2-Llama3-76B — VLM: InternViT-6B vision frontend (stubbed to
patch embeddings per assignment) + Llama3-70B-class language backbone.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    source="InternVL2 [arXiv:2404.16821]; backbone Llama3-70B geometry",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    frontend="vision",
    frontend_seq=256,      # ViT patch embeddings delivered by the stub
    frontend_dim=3200,     # InternViT-6B hidden size
)
