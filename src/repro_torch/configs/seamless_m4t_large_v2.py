"""SeamlessM4T-large-v2 — encoder-decoder multimodal (audio frontend
stubbed to frame embeddings per assignment). [arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    source="SeamlessM4T v2 [arXiv:2308.11596]",
    n_layers=24,           # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    enc_dec=True,
    n_enc_layers=24,
    enc_seq_len=4096,      # speech frames after the (stubbed) conv frontend
    frontend="audio",
    frontend_seq=4096,
    frontend_dim=1024,     # w2v-BERT frame embedding dim (stub delivers these)
)
