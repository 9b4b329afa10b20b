"""StarCoder2-3B — dense, GQA kv=2, RoPE. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    source="StarCoder2 [arXiv:2402.19173]",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    sliding_window=4096,    # starcoder2 uses sliding-window attention
)
