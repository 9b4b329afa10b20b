"""InternLM2-1.8B — dense GQA. [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    source="InternLM2 [arXiv:2403.17297]",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
)
