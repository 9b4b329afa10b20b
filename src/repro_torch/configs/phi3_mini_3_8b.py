"""Phi-3-mini 3.8B — dense, RoPE + SwiGLU, MHA (GQA kv=32). [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    source="Phi-3 [arXiv:2404.14219]",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
)
