"""DeepSeek-V2-Lite 16B — MLA (kv_lora=512) + MoE (2 shared + 64 routed,
top-6). [arXiv:2405.04434]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="DeepSeek-V2(-Lite) [arXiv:2405.04434]",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,            # first dense layer FFN
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense_layers=1,
    use_mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
)
