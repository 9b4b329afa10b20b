"""Llama-3.2-3B — small dense llama3 family. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    arch_type="dense",
    source="Llama 3.2 [hf:meta-llama/Llama-3.2-1B family]",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
)
