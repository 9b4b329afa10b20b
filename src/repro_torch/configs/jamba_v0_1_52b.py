"""Jamba-v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    source="Jamba [arXiv:2403.19887]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    moe_every=2,
    attn_period=8,
    attn_offset=4,         # 1 attention layer per 8; rest mamba
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
)
