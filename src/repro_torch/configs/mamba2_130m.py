"""Mamba2-130M — pure SSM (SSD / state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    source="Mamba2 / SSD [arXiv:2405.21060]",
    n_layers=24,
    d_model=768,
    n_heads=12,            # unused by the mamba mixer; kept for schema
    n_kv_heads=12,
    d_ff=0,                # attn-free, no MLP blocks: mixer-only layers
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,       # d_inner=1536 → 24 SSD heads
    ssm_chunk=256,
)
