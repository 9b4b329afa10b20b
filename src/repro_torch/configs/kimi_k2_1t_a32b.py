"""Kimi K2 — trillion-parameter MoE, 32B active (paper-table geometry).
[arXiv:2501.kimi2]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    source="Kimi K2 [arXiv:2501.kimi2]",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=18432,            # dense FFN of the first layer
    vocab_size=163840,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    first_dense_layers=1,
    rope_theta=50000.0,
)
